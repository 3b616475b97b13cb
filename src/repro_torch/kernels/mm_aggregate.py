"""Fused elementwise (weighted, batched) MM aggregation on Hopper.

Counterpart of ``repro.kernels.mm_aggregate``.  Per model coordinate m
and combination weights a (Eq. 10/13; uniform a recovers Eq. 8):

    med   = wmedian_k(phi[k, m]; a)                   (robust init)
    s     = 1.4826 * median_k |phi[k, m] - med|       (MAD scale)
    mu_0  = med
    T x:  b_k = tukey_w((phi[k,m] - mu_t) / (c*s))
          mu_{t+1} = sum a_k b_k phi / sum a_k b_k

Two hand-written CUDA kernels compute it (``csrc/``): the single-pass
kernel, in three variants (``regs``: a column's K <= 32 values in one
thread's registers; ``warp``: one warp per (column, n) pair, K <= 64;
``smem``: a block's whole (K, bm) tile in shared memory), and the
two-pass K-major kernel for large cohorts, which sorts each column's
bk-row blocks and combines their statistics (one K block: a group of
lanes a column, 16 or 32 rows a lane, which also does the column's
serial work; several: one warp a column).  Each
sits behind a wrapper here (``single_pass``, ``two_pass``) that launches
it for a CUDA tensor, one kernel per call, and counts the launch under
its ``KernelCall.key`` in ``launches.COUNTS``; for a CPU tensor the
wrapper runs the plain PyTorch version beside it
(``mm_single_pass_plain``, ``mm_two_pass_plain``), which repeats the TPU
kernel's arithmetic on the padded operands: the sorted-order f32
cumulative weights, the crossing with no epsilon, the rank midpoints,
and the per-block approximation.

The wrappers take x as a (K, M) tensor or, in a weighted launch on the
card, as a ``RowTable``: K rows that lie anywhere, each contiguous, given
by a device table of their addresses, which the kernels read in place of
x (the streaming service's launch program reads its cohort so, copying
nothing).  Both launch the same plan and read the same elements in the
same order, so they give the same bits.

``kernel_call`` turns a plan into the launch the wrapper makes, as data
(``KernelCall``: the kernel's instantiation, threads, shared memory, the
units its blocks walk, its operands), and the wrappers take their launch
arguments from it; ``repro_torch.analysis.contracts`` audits it against
the plan, and on the card against the C entry points' own report
(``launch_query``).  Inside a ``record_calls()`` scope every wrapper call
appends its ``KernelCall``, on any device.  A wrapper given a tensor on
the meta device records its call and returns an empty (N, M) meta tensor:
shape-only work for the dry run (``launch.dryrun``), which computes
nothing.

``launch_plan`` is the single source of truth for a launch's geometry,
its modeled HBM traffic and the shared memory a block carves, against
Hopper's 227 KB (232,448 B) per block.  The path crossover
(``auto_path``) is measured, not derived from that limit: from 65
agents the two-pass kernel, timed when it still gave each column a
warp, outruns the single pass's smem variant (which ranks a
column's rows by counting, K^2 compares) 1.6-7x at N = 1 over 2^20
columns from K = 76 to 256, except at a few agents over 64 and many
weight columns, where the single pass stays.  Within the single pass,
``single_pass_variant`` picks the variant from (K, M, N) alone; the plan
records it and the launcher never substitutes another.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import location, mestimators
from repro_torch.kernels import build, launches

SMEM_BUDGET_BYTES = 232_448      # shared memory one Hopper block may use
_MIN_BLOCK_M = 32                # one warp of columns: coalesced row reads
_MAX_BLOCK_M = 256
SINGLE_PASS_MIN_BLOCK_M = 128
_SCALE_FLOOR = 1e-12
_MAD_CONSISTENCY = 1.4826022185056018

PATHS = ("single", "two_pass")
_TWO_PASS_MIN_K = 65
# (largest N of a bracket, largest K the single pass keeps there; above
# the last bracket, its K): from 65 agents the two-pass kernel is faster
# unless the smem variant's sort stays cheap against the two-pass
# kernel's IRLS, which costs it more for every weight column
SMEM_KEEPS = ((1, 68), (4, 72), (8, 80), (16, 96), (32, 112), (64, 160),
              (128, 192))
# largest K block the two-pass path sorts at once (more K -> several
# blocks -> the approximate median-of-medians init, as in the reference)
_MAX_BLOCK_K2 = 512
# the two-pass kernel with several K blocks (the warp layout): block_m
# columns a block, one warp each, at most 8; its (K_pad, block_m) tile
# must fit, so large K takes fewer columns
TWO_PASS_BLOCK_MS = (8, 4, 2, 1)
# with one K block (the group layout) a column's rows spread over a group
# of lanes, 16 rows a lane up to bk = _TWO_PASS_GROUP_SPLIT and 32 above,
# and a block takes any power of two of columns up to this many threads'
# worth
TWO_PASS_GROUP_THREADS = 256
_TWO_PASS_GROUP_SPLIT = 128
# the heuristic narrows the block until M gives one tile per SM (H100 SXM)
TWO_PASS_MIN_TILES = 132
# K blocks a warp combines in registers; above, in shared memory
_TWO_PASS_REG_COMBINE = 32
# most shared memory the two-pass (n_chunk, K_pad) weight slice takes
_TWO_PASS_WEIGHT_SLICE_BYTES = 64 * 1024

# single-pass variants (csrc/mm_single_pass.cu), by their C codes
SINGLE_PASS_VARIANTS = {"regs": 0, "warp": 1, "smem": 2}
# the MM kernels' names in launches.COUNTS
MM_KERNELS = (*SINGLE_PASS_VARIANTS, "two_pass")
# most rows a variant holds: regs' largest template bound; warp's two
# rows per lane
VARIANT_MAX_K = {"regs": 32, "warp": 64}
# regs runs one thread per column in blocks of up to 256: below 66 such
# blocks (16,896 columns) its grid covers less than half of the card's
# 132 SMs, so most of the card would idle
REGS_MIN_COLUMNS = 66 * 256
# warp runs one warp per (column, n) pair: 32 lanes for work that regs
# and smem give one thread.  It pays while the pairs fit one wave of 32
# warps on each of the 132 SMs; past that the card is full either way
WARP_MAX_PAIRS = 132 * 32

# the lists of the open record_calls() scopes
_CALL_RECORDERS: list = []

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RowTable(NamedTuple):
    """K rows of M values each, read where they lie: ``table`` is a (K,)
    int64 tensor of the rows' addresses on their CUDA device.  Each row
    is a contiguous tensor of ``dtype``; the caller keeps the rows alive
    until the launches that read them have run.  It stands for a (K, M)
    x in the wrappers of a weighted launch, which pass the table to the
    kernel in place of x (``shape``, ``dtype`` and ``device`` are x's)."""
    table: torch.Tensor
    m: int
    dtype: torch.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.table.shape[0], self.m)

    @property
    def device(self) -> torch.device:
        return self.table.device


Rows = Union[torch.Tensor, RowTable]


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _as_dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 2)."""
    p = 2
    while p < n:
        p *= 2
    return p


class LaunchPlan(NamedTuple):
    """Static geometry + modeled HBM traffic of one batched launch.

    ``grid`` is (column tiles, K blocks); the K blocks are a loop inside
    each block.  The single-pass ``warp`` variant's grid counts blocks of
    eight (column, n) pairs.  For ``regs`` and the two-pass kernel
    ``grid[0]`` counts column tiles, not blocks launched: they walk their
    tiles grid-stride on min(tiles, blocks the card holds at once)
    blocks, a number the launcher asks of the current card and caches per
    device (``two_pass_blocks`` reports it for a two-pass plan).
    Traffic counts what the kernel moves: each x element once (both
    kernels keep a column's whole tile on chip; a plan whose tile does
    not fit raises on the card), the weights, and the (N, M) output; it
    does not depend on ``n_out``.  ``n_chunk`` is the weight columns a
    block holds at once: ``n_out`` on the single pass, the two-pass
    kernel's staged (n_chunk, K_pad) weight slice.
    """
    grid: Tuple[int, int]
    block_m: int
    block_k: int
    k_pad: int
    m_total: int
    n_out: int
    input_block_fetches: int
    input_bytes: int
    weight_bytes: int
    output_bytes: int
    path: str = "single"
    n_chunk: int = 1
    num_k_blocks: int = 1
    stats_bytes: int = 0      # shared-memory pass-1 stats, never in HBM
    smem_bytes: int = 0       # shared memory one block carves
    variant: Optional[str] = None   # single-pass variant; None for two-pass

    @property
    def total_bytes(self) -> int:
        """Total modeled HBM traffic of one launch."""
        return self.input_bytes + self.weight_bytes + self.output_bytes


def single_pass_smem_bytes(k: int, n: int, block_m: int) -> int:
    """Shared memory of the single-pass smem variant: the (K, bm) f32
    tile, the (K, N) weight tile and the (K, bm) uint16 row-index tile
    (the C function ``mm_single_pass_smem_bytes`` computes the same)."""
    return 4 * k * block_m + 4 * k * n + 2 * k * block_m


def variant_smem_bytes(variant: str, k: int, n: int, block_m: int) -> int:
    """Shared memory one block of a single-pass variant carves (C:
    ``mm_single_pass_smem_bytes``): regs stages only the (K, N) weights,
    at an odd row stride; warp none; smem its whole tile."""
    if variant == "regs":
        return 4 * k * (n | 1)
    if variant == "warp":
        return 0
    return single_pass_smem_bytes(k, n, block_m)


def single_pass_variant(k: int, m: int, n: int = 1) -> str:
    """The single-pass variant for a (K, M) x (K, N) launch: regs for
    K <= 32 over wide M; warp for K <= 64 while the (column, n) pairs
    fit one wave of warps; regs for any other K <= 32; else smem."""
    k, m, n = int(k), int(m), int(n)
    if k <= VARIANT_MAX_K["regs"] and m >= REGS_MIN_COLUMNS:
        return "regs"
    if k <= VARIANT_MAX_K["warp"] and m * n <= WARP_MAX_PAIRS:
        return "warp"
    if k <= VARIANT_MAX_K["regs"]:
        return "regs"
    return "smem"


def two_pass_rows(block_k: int) -> int:
    """Rows a lane holds in the two-pass kernel's group layout (one K
    block): 16 up to a K block of 128 rows, 32 above (C: group_rows)."""
    return 16 if int(block_k) <= _TWO_PASS_GROUP_SPLIT else 32


def two_pass_lanes(block_k: int) -> int:
    """Lanes a column holds in the group layout: bk / rows a lane, at
    least one (C: group_lanes)."""
    return max(1, int(block_k) // two_pass_rows(block_k))


def two_pass_block_ms(k: int, block_k: int) -> Tuple[int, ...]:
    """The blocks of columns the two-pass kernel takes for K at this K
    block, widest first: ``TWO_PASS_BLOCK_MS`` with several K blocks (one
    warp a column); with one, every power of two up to
    ``TWO_PASS_GROUP_THREADS`` / lanes (a group of lanes a column)."""
    if -(-int(k) // int(block_k)) > 1:
        return TWO_PASS_BLOCK_MS
    widest = TWO_PASS_GROUP_THREADS // two_pass_lanes(block_k)
    return tuple(widest >> i for i in range(widest.bit_length()))


def two_pass_smem_bytes(k: int, n_chunk: int, block_k: int,
                        block_m: int, *, table: bool = False) -> int:
    """Shared memory one block of the two-pass kernel carves (C:
    ``mm_two_pass_smem_bytes``).  One K block: the (n_chunk, bk) weight
    slice, n_chunk masses and the sorted columns' f32 values and uint16
    rows in strips laid out for the widest block, rows a lane x 256
    entries each, whatever ``block_m``; a launch that reads its rows
    through a ``RowTable`` (``table``) adds the block's copy of the k
    addresses, 8 k bytes on a 16-byte boundary (several K blocks read
    the table where it lies, and carve nothing for it).  Several: above 32 K
    blocks each warp's strip of next_pow2(KB) 8-byte (value, block) pairs
    for the combine; the (K_pad, bm) f32 tile, the (n_chunk, K_pad)
    weight slice, (2 KB, bm) block stats, (KB, n_chunk) block masses and
    the (K_pad, bm) uint16 row index of the sorted blocks."""
    kb = -(-k // block_k)
    k_pad = kb * block_k
    if kb == 1:
        strip = two_pass_rows(block_k) * TWO_PASS_GROUP_THREADS
        own = 4 * (n_chunk * k_pad + n_chunk + strip) + 2 * strip
        return -(-own // 16) * 16 + 8 * k if table else own
    strip = next_pow2(kb) if kb > _TWO_PASS_REG_COMBINE else 0
    return (8 * block_m * strip
            + 4 * (k_pad * block_m + n_chunk * k_pad + 2 * kb * block_m
                   + kb * n_chunk)
            + 2 * k_pad * block_m)


def two_pass_n_chunk(k: int, n: int, block_k: int, block_m: int) -> int:
    """Weight columns the two-pass kernel stages at once: all N while the
    (n_chunk, K_pad) slice stays within 64 KB, else as many as do (at
    least one), fewer while the block does not fit."""
    k_pad = -(-k // block_k) * block_k
    nc = max(1, min(int(n), _TWO_PASS_WEIGHT_SLICE_BYTES // (4 * k_pad)))
    while nc > 1 and two_pass_smem_bytes(k, nc, block_k, block_m) > \
            SMEM_BUDGET_BYTES:
        nc -= 1
    return nc


def two_pass_block_k(k: int) -> int:
    """Default K block: one power-of-two block over the whole axis while
    it has <= 512 rows (exact), else 512-row blocks (approximate init)."""
    return min(next_pow2(max(int(k), 2)), _MAX_BLOCK_K2)


def auto_path(k: int, n: int) -> str:
    """Two-pass from 65 agents, except up to the K that ``SMEM_KEEPS``
    gives N, where the smem variant ran more than 5% faster on an H100
    (weighted f32 at M = 2^20; the same at M = 15,730,944 and in bf16),
    while its tile fits a block at 32 columns.  It depends on (K, N)
    only, so M never flips the path, though over fewer than ~2^16
    columns the two-pass kernel is 2-16x faster there too (the smem
    variant's few blocks do not fill the card)."""
    k, n = int(k), max(int(n), 1)
    keeps = next((kk for top_n, kk in SMEM_KEEPS if n <= top_n),
                 SMEM_KEEPS[-1][1])
    if k < _TWO_PASS_MIN_K or (k <= keeps and single_pass_smem_bytes(
            k, n, _MIN_BLOCK_M) <= SMEM_BUDGET_BYTES):
        return "single"
    return "two_pass"


def launch_plan(k: int, m: int, n: int = 1, *,
                dtype=torch.float32,
                block_m: Optional[int] = None,
                block_k: Optional[int] = None,
                path: Optional[str] = None,
                variant: Optional[str] = None,
                n_chunk: Optional[int] = None,
                table: bool = False) -> LaunchPlan:
    """Resolve the kernel path + tile sizes (via kernels.tuning when
    unset) and derive the grid, modeled HBM traffic and shared memory of
    a (K, M) x (K, N) launch.  ``path=None`` takes the cached tuning
    choice when it names a path, else ``auto_path``; a named ``variant``
    pins the single pass.  The single-pass kernel loads all K rows as one
    block, so ``block_k`` and ``n_chunk`` (None: ``two_pass_n_chunk``)
    apply to the two-pass path only; ``variant=None`` takes
    ``single_pass_variant``, and a variant named for a K it cannot hold
    raises."""
    if path is not None and path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; known: {PATHS}")
    if variant is not None and variant not in SINGLE_PASS_VARIANTS:
        raise ValueError(f"unknown single-pass variant {variant!r}; known: "
                         f"{tuple(SINGLE_PASS_VARIANTS)}")
    dtype = _as_dtype(dtype)
    if variant is not None and path is None:
        path = "single"
    bm_given, tuned_bk = block_m is not None, None
    if block_m is None or block_k is None or path is None:
        from repro_torch.kernels import tuning  # deferred: tuning sizes plans
        choice = tuning.get_choice(k, m, n=n, dtype=dtype)
        if path is None:
            path = choice.path
        if (path or auto_path(k, n)) != (choice.path or auto_path(k, n)):
            # a tile chosen for the other path: the heuristic's for this one
            choice = tuning.TuneChoice(*tuning.heuristic_blocks(
                k, m, n, dtype, path=path))
        if block_m is None:
            block_m = choice.block_m
        tuned_bk = choice.block_k
        if block_k is None and (choice.path or "single") == \
                (path or auto_path(k, n)):
            block_k = choice.block_k
    if path is None:
        path = auto_path(k, n)
    if path == "two_pass":
        bk = two_pass_block_k(k) if block_k is None else int(block_k)
        if bk < 2 or bk & (bk - 1):
            raise ValueError(
                f"two-pass block_k must be a power of two >= 2, got {bk}")
        if not bm_given and bk != (tuned_bk or two_pass_block_k(k)):
            # the tile was chosen for another K block: this one's heuristic
            from repro_torch.kernels import tuning
            block_m = tuning.heuristic_blocks(k, m, n, dtype, path=path,
                                              block_k=bk)[0]
        if block_m not in two_pass_block_ms(k, bk):
            raise ValueError(f"the two-pass kernel takes block_m in "
                             f"{two_pass_block_ms(k, bk)} at (K, block_k) = "
                             f"({k}, {bk}), got {block_m}")
    if block_m < 1:
        raise ValueError(f"block_m must be positive, got {block_m}")

    itemsize = torch.empty((), dtype=dtype).element_size()
    m_total = m + ((-m) % block_m)
    tiles = m_total // block_m
    weight_bytes = k * n * 4
    output_bytes = n * m * itemsize

    if path == "two_pass":
        kb = -(-k // bk)
        nc = two_pass_n_chunk(k, n, bk, block_m) if n_chunk is None \
            else max(1, min(int(n_chunk), n))
        return LaunchPlan(
            grid=(tiles, kb), block_m=block_m, block_k=bk, k_pad=kb * bk,
            m_total=m_total, n_out=n,
            input_block_fetches=tiles * kb,
            input_bytes=k * m * itemsize,
            weight_bytes=weight_bytes, output_bytes=output_bytes,
            path=path, n_chunk=nc, num_k_blocks=kb,
            stats_bytes=2 * kb * block_m * 4,
            smem_bytes=two_pass_smem_bytes(k, nc, bk, block_m, table=table),
        )

    variant = variant or single_pass_variant(k, m, n)
    max_k = VARIANT_MAX_K.get(variant)
    if max_k is not None and k > max_k:
        raise ValueError(f"the {variant} variant holds at most {max_k} "
                         f"rows, got K={k}")
    # warp launches one warp per (column, n) pair, eight to a block
    grid = -(-m * n // 8) if variant == "warp" else tiles
    return LaunchPlan(
        grid=(grid, 1), block_m=block_m, block_k=k, k_pad=k,
        m_total=m_total, n_out=n,
        input_block_fetches=tiles,
        input_bytes=k * m * itemsize,
        weight_bytes=weight_bytes, output_bytes=output_bytes,
        path=path, n_chunk=n, num_k_blocks=1,
        stats_bytes=0,
        smem_bytes=variant_smem_bytes(variant, k, n, block_m),
        variant=variant,
    )


def modeled_ops(k: int, m: int, n: int, weighted: bool, num_iters: int = 10,
                sort_rows: int = 0) -> int:
    """f32 operations the MM estimate of a (k, m) x (k, n) launch needs,
    an FMA counted as two (as the peak rate counts it).  Per (column, n)
    and IRLS step, each row takes 9: r = x - mu, r * r, 1 - r^2 / (c
    scale)^2 as one FMA against the folded constant, the clamp at 0, the
    square, num += w x as an FMA, den += w; weights add one multiply.
    Each step adds the divide and the test, and the folded constant costs
    3 once.  The start takes 2 per row for the deviations and compares of
    the MAD and, weighted, 2 for the cumulative weight and its compare.
    Sorting a column costs K log2 K compares (log2 of the sorted block,
    ``sort_rows``, where the column is sorted in blocks)."""
    per_row = 9 + int(weighted)
    start = 2 * k + (2 * k if weighted else 2) + 3
    sort = k * max(1, math.ceil(math.log2(max(sort_rows or k, 2))))
    return n * m * (num_iters * (per_row * k + 2) + start) + m * sort


class Operand(NamedTuple):
    """One array a launch reads or writes in HBM."""
    name: str
    shape: Tuple[int, ...]
    dtype: str


class KernelCall(NamedTuple):
    """The launch one wrapper call makes for ``plan``, as data.

    Built by ``kernel_call``, whose ``args`` the wrappers hand to the C
    entry point, so ``repro_torch.analysis.contracts`` audits the launch
    that runs.  ``units`` are what the blocks walk (column tiles; for
    ``warp``, blocks of eight (column, n) pairs), ``stride`` the step of
    that walk (block b takes units b, b + stride, ...; 0: the blocks
    launched, as every kernel steps by its grid), ``grid_stride``
    whether the card decides the blocks (min(units, blocks it holds at
    once)) or each unit has its own block.  ``tile`` is the (rows,
    columns) of x one load brings on chip and ``loads`` how many such
    loads the launch makes.  ``operands`` are x (K, M) in its dtype, a
    (K, N) f32 and the (N, M) output; ``outputs`` the HBM outputs."""
    plan: LaunchPlan
    instantiation: str
    threads: int
    smem: int
    units: int
    stride: int
    grid_stride: bool
    tile: Tuple[int, int]
    loads: int
    operands: Tuple[Operand, ...]
    outputs: Tuple[Operand, ...]
    args: Tuple[int, ...]       # the C launch's geometry arguments
    weighted: bool = True
    num_iters: int = 10

    @property
    def k(self) -> int:
        return self.operands[0].shape[0]

    @property
    def m(self) -> int:
        return self.operands[0].shape[1]

    @property
    def key(self) -> tuple:
        """(variant or "two_pass", K, M, N): the launch's key in
        ``launches.COUNTS``."""
        return (self.plan.variant or "two_pass", self.k, self.m,
                self.plan.n_out)

    def blocks(self, held: Optional[int] = None) -> int:
        """Blocks launched when the card holds ``held`` blocks at once."""
        if not self.grid_stride:
            return self.units
        return min(self.units, held) if held is not None else self.units

    @property
    def ops(self) -> int:
        """``modeled_ops`` of the launch."""
        two = self.plan.path == "two_pass"
        return modeled_ops(self.k, self.m, self.plan.n_out, self.weighted,
                           self.num_iters,
                           sort_rows=self.plan.block_k if two else 0)

    def to_dict(self) -> dict:
        return {"kernel": self.instantiation, "key": list(self.key),
                "dtype": self.operands[0].dtype, "weighted": self.weighted,
                "threads": self.threads, "smem": self.smem,
                "units": self.units, "grid_stride": self.grid_stride,
                "tile": list(self.tile), "loads": self.loads,
                "bytes": self.plan.total_bytes, "ops": self.ops}


_TYPE_NAMES = {torch.float32: "float", torch.bfloat16: "bf16"}


def kernel_call(plan: LaunchPlan, *, k: int, m: int, dtype=torch.float32,
                weighted: bool = True, num_iters: int = 10,
                table: bool = False) -> KernelCall:
    """The launch ``plan`` makes over a (k, m) x (``table``: over k rows
    given by a ``RowTable``), as the C entry points configure it: the
    instantiation their dispatch picks, threads a block, dynamic shared
    memory, the walk and the operands.  Launches nothing."""
    return _realized_call(plan, int(k), int(m), _as_dtype(dtype),
                          bool(weighted), int(num_iters), bool(table))


# a wrapper asks for its call on every launch: the same few geometries
# over and over (a scenario's steps, a train step's leaves), so the
# immutable calls are kept rather than rebuilt on the launch's host path
@functools.lru_cache(maxsize=4096)
def _realized_call(plan: LaunchPlan, k: int, m: int, dtype: torch.dtype,
                   weighted: bool, num_iters: int, table: bool) -> KernelCall:
    n = plan.n_out
    tname = _TYPE_NAMES[dtype]
    tiles = -(-m // plan.block_m)
    if plan.path == "two_pass":
        # <rows a lane, weighted, dtype, lanes a column>: one K block, the
        # group layout; several, one warp a column
        if plan.num_k_blocks == 1:
            rpl, lanes = two_pass_rows(plan.block_k), \
                two_pass_lanes(plan.block_k)
            threads = max(32, plan.block_m * lanes)
        else:
            rpl, lanes = max(1, plan.block_k // 32), 32
            threads = 32 * plan.block_m
        inst = f"mm_two_pass<{rpl}, {'true' if weighted else 'false'}, " \
               f"{tname}, {lanes}>"
        units, grid_stride = tiles, True
        smem = two_pass_smem_bytes(k, plan.n_chunk, plan.block_k,
                                   plan.block_m, table=table)
        # its (K_pad, bm) tile arrives as num_k_blocks (bk, bm) loads
        tile, loads = (plan.block_k, plan.block_m), tiles * plan.num_k_blocks
        args = (plan.block_k, plan.n_chunk, plan.block_m)
    else:
        v = plan.variant
        smem = variant_smem_bytes(v, k, n, plan.block_m)
        args = (plan.block_m, SINGLE_PASS_VARIANTS[v])
        if v == "regs":
            kmax = 8 if k <= 8 else 16 if k <= 16 else 32
            inst, threads = f"mm_regs<{kmax}, {tname}>", plan.block_m
            units, grid_stride = tiles, True
            tile, loads = (k, plan.block_m), tiles
        elif v == "warp":
            # one warp a (column, n) pair, eight to a block: each warp
            # loads its column, so a column is loaded once per n
            inst = f"mm_warp<{1 if k <= 32 else 2}, {tname}>"
            threads, units, grid_stride = 256, -(-m * n // 8), False
            tile, loads = (k, 1), m * n
        else:
            inst, threads = f"mm_smem<{tname}>", 256
            units, grid_stride = tiles, False
            tile, loads = (k, plan.block_m), tiles
    dname = dtype_name(dtype)
    out = Operand("out", (n, m), dname)
    return KernelCall(
        plan=plan, instantiation=inst, threads=threads, smem=smem,
        units=units, stride=0, grid_stride=grid_stride, tile=tile,
        loads=loads,
        operands=(Operand("x", (k, m), dname),
                  Operand("a", (k, n), "float32"), out),
        outputs=(out,), args=args, weighted=weighted, num_iters=num_iters)


def launch_query(call: KernelCall) -> dict:
    """What the C entry point would launch for ``call`` on the current
    card, through its own dispatch (``mm_*_config``), launching nothing:
    the instantiation, blocks, threads, dynamic shared memory, the blocks
    of that size one SM holds (0 where none fits) and the SM count, for
    the launch over a (K, M) x (the C query takes no row table)."""
    out = (ctypes.c_int64 * 5)()
    name = ctypes.create_string_buffer(96)
    code = _DTYPE_CODES[_as_dtype(call.operands[0].dtype)]
    if call.plan.path == "two_pass":
        lib = build.library("mm_two_pass")
        err = lib.mm_two_pass_config(code, call.k, call.m, call.plan.n_out,
                                     *call.args, int(call.weighted),
                                     ctypes.byref(out), ctypes.byref(name),
                                     len(name))
        smem_model = lib.mm_two_pass_smem_bytes(
            call.k, call.plan.n_chunk, call.plan.block_k, call.plan.block_m,
            0)
    else:
        lib = build.library("mm_single_pass")
        err = lib.mm_single_pass_config(code, call.k, call.m,
                                        call.plan.n_out, *call.args,
                                        ctypes.byref(out), ctypes.byref(name),
                                        len(name))
        smem_model = lib.mm_single_pass_smem_bytes(
            call.args[1], call.k, call.plan.n_out, call.plan.block_m)
    if err:
        raise RuntimeError(f"launch query for {call.instantiation} failed: "
                           f"cudaError {err}")
    return {"instantiation": name.value.decode(), "blocks": out[0],
            "threads": out[1], "smem": out[2], "per_sm": out[3],
            "sms": out[4], "smem_model": smem_model}


@contextlib.contextmanager
def record_calls():
    """Collect the ``KernelCall`` of every wrapper call made inside the
    scope, one per call, on every device (the CPU's plain versions, the
    card, CUDA-graph capture and the meta device).  ``launches.COUNTS``
    counts launches on the card only."""
    records: list = []
    _CALL_RECORDERS.append(records)
    try:
        yield records
    finally:
        for i, r in enumerate(_CALL_RECORDERS):
            if r is records:
                del _CALL_RECORDERS[i]
                break


def _record_call(call: KernelCall) -> None:
    for records in _CALL_RECORDERS:
        records.append(call)


def _pad_inputs(x: torch.Tensor, a: torch.Tensor, *, plan: LaunchPlan
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (K, M) values and (K, N) weights to the plan's geometry, as
    the reference lays them out for its kernel: K to ``plan.k_pad`` with
    +inf rows of weight 0, M to ``plan.m_total`` with ZERO columns (+inf
    columns would give inf - inf = NaN in the MAD).  The plain versions
    read these; the CUDA kernels mask the ragged edge themselves, so a
    multi-GB input is never copied to pad it."""
    k, m = x.shape
    xp = x
    if plan.k_pad != k:
        xp = torch.cat([xp, torch.full((plan.k_pad - k, m), float("inf"),
                                       dtype=x.dtype, device=x.device)])
    if plan.m_total != m:
        xp = torch.cat([xp, torch.zeros((plan.k_pad, plan.m_total - m),
                                        dtype=x.dtype, device=x.device)], 1)
    ap = a.to(torch.float32)
    if plan.k_pad != k:
        ap = torch.cat([ap, torch.zeros((plan.k_pad - k, ap.shape[1]),
                                        dtype=torch.float32, device=a.device)])
    return xp, ap


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------

def _gather_rows(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Weights a (R, N) permuted per column by order (R, M) -> (R, N, M)."""
    return a[order].permute(0, 2, 1)


def _crossing(xs: torch.Tensor, ws: torch.Tensor, half) -> torch.Tensor:
    """Value at the first sorted row whose cumulative weight reaches
    ``half`` while the previous one is below it (no epsilon); 0 where no
    row crosses.  xs (R, ...) broadcasts against ws (R, N, ...); the
    cumulative sum runs row by row in f32, the kernels' order."""
    cw = torch.zeros_like(ws[0])
    out = torch.zeros_like(ws[0])
    for j in range(ws.shape[0]):
        prev = cw
        cw = cw + ws[j]
        sel = (cw >= half) & (prev < half)
        out = torch.where(sel, xs[j].expand_as(out), out)
    return out


def _sequential_sum(ws: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 row by row in f32 (the kernels' order)."""
    s = torch.zeros_like(ws[0])
    for j in range(ws.shape[0]):
        s = s + ws[j]
    return s


def _rank_median(xs: torch.Tensor, cnt: int) -> torch.Tensor:
    return 0.5 * (xs[(cnt - 1) // 2] + xs[cnt // 2])


def _irls(x: torch.Tensor, a: torch.Tensor, mu: torch.Tensor,
          scale: torch.Tensor, *, num_iters: int, c: float) -> torch.Tensor:
    """Tukey IRLS from mu (N, M): x (K, M) valid rows, a (K, N)."""
    c2 = c * c
    xb = x[:, None, :]
    aw = a[:, :, None]
    for _ in range(num_iters):
        y = (xb - mu[None]) / scale[None]
        u = torch.clamp(1.0 - (y * y) / c2, 0.0, 1.0)
        w = aw * (u * u)
        num = torch.sum(w * xb, dim=0)
        den = torch.sum(w, dim=0)
        safe = den > _SCALE_FLOOR
        mu = torch.where(safe, num / torch.where(safe, den,
                                                 torch.ones_like(den)), mu)
    return mu


def mm_single_pass_plain(xp: torch.Tensor, ap: torch.Tensor, *, k: int,
                         num_iters: int = 10,
                         c: float = mestimators.TUKEY_C95,
                         weighted: bool = True) -> torch.Tensor:
    """Plain version of the single-pass kernel on padded operands:
    (K_pad, M_pad) values, (K_pad, N) normalized weights -> (N, M_pad).
    Sentinel rows (+inf, weight 0) sort last and never cross, so only
    the k valid rows are read."""
    x = xp[:k].to(torch.float32)
    a = ap[:k].to(torch.float32)
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    if weighted:
        med = _crossing(xs[:, None, :], _gather_rows(a, order), 0.5)
    else:
        med = _rank_median(xs, k)[None]
    ds = torch.sort(torch.abs(x[:, None, :] - med[None]), dim=0).values
    scale = torch.clamp(_MAD_CONSISTENCY * _rank_median(ds, k),
                        min=_SCALE_FLOOR)
    mu = _irls(x, a, med.expand_as(scale).clone(), scale,
               num_iters=num_iters, c=c)
    return mu.to(xp.dtype)


def mm_two_pass_plain(xp: torch.Tensor, ap: torch.Tensor, *, k: int,
                      block_k: int, num_iters: int = 10,
                      c: float = mestimators.TUKEY_C95,
                      weighted: bool = True) -> torch.Tensor:
    """Plain version of the two-pass kernel on padded operands, with the
    reference's per-block approximation: block (weighted) medians at
    half the block mass, block MADs over the block's valid rows, a
    mass-weighted median of each, then IRLS summed over every row."""
    x = xp[:k].to(torch.float32)
    a = ap.to(torch.float32)                       # (K_pad, N), pads 0
    bk = block_k
    kb = -(-k // bk)
    meds, mads, mass = [], [], []
    for b in range(kb):
        r0 = b * bk
        cnt = min(k - r0, bk)
        xb = x[r0:r0 + cnt]
        order = torch.argsort(xb, dim=0, stable=True)
        xs = torch.take_along_dim(xb, order, dim=0)
        if weighted:
            ws = _gather_rows(a[r0:r0 + cnt], order)
            med = _crossing(xs[:, None, :], ws, 0.5 * _sequential_sum(ws))
        else:
            med = _rank_median(xs, cnt)[None]
        ds = torch.sort(torch.abs(xs[:, None, :] - med[None]), dim=0).values
        meds.append(med)
        mads.append(_rank_median(ds, cnt))
        mass.append(_sequential_sum(a[r0:r0 + bk]))
    mass = torch.stack(mass)                                  # (KB, N)
    half = (0.5 * _sequential_sum(mass))[:, None]             # (N, 1)

    def combine(stats):
        st = torch.stack(stats)                               # (KB, N, M)
        order = torch.argsort(st, dim=0, stable=True)
        mw = torch.take_along_dim(mass[:, :, None].expand_as(st), order, 0)
        return _crossing(torch.take_along_dim(st, order, 0), mw, half)

    mu0 = combine(meds)
    scale = torch.clamp(_MAD_CONSISTENCY * combine(mads), min=_SCALE_FLOOR)
    mu = _irls(x, a[:k], mu0, scale, num_iters=num_iters, c=c)
    return mu.to(xp.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda_operands(x: Rows, a: torch.Tensor, plan: LaunchPlan,
                         k: int) -> None:
    if plan.smem_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"{plan.path} plan needs {plan.smem_bytes} B of shared memory "
            f"per block, over the {SMEM_BUDGET_BYTES} B a block may use")
    if plan.path == "two_pass" and plan.block_k > _MAX_BLOCK_K2:
        raise ValueError(f"the two-pass kernel sorts blocks of at most "
                         f"{_MAX_BLOCK_K2} rows, got block_k={plan.block_k}")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the MM kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if isinstance(x, RowTable):
        t = x.table
        if t.dtype != torch.int64 or tuple(t.shape) != (k,) or \
                not t.is_contiguous() or x.m < 1:
            raise ValueError(f"a row table must be a contiguous int64 ({k},) "
                             f"tensor of the addresses of rows of M>=1 values")
    elif x.dim() != 2 or x.shape[0] != k or x.shape[1] < 1:
        raise ValueError(f"x must be ({k}, M>=1), got {tuple(x.shape)}")
    elif x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("x rows must be contiguous (stride 1 along M)")
    if a.dtype != torch.float32 or a.device != x.device or \
            tuple(a.shape) != (k, plan.n_out) or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous float32 ({k}, "
                         f"{plan.n_out}) tensor on {x.device}")


def _launch_args(x: Rows, a, out, plan):
    """The C entry point's leading arguments: x, the row table (0: none),
    dtype, the row stride, K, M, a, N and out; and the stream."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    k, m = x.shape
    if isinstance(x, RowTable):
        xp, rows, ld = 0, x.table.data_ptr(), m
    else:
        xp, rows, ld = x.data_ptr(), 0, x.stride(0)
    return (xp, rows, _DTYPE_CODES[x.dtype], ld, k, m, a.data_ptr(),
            plan.n_out, out.data_ptr()), stream


def _wrapper_call(x: Rows, plan: LaunchPlan, weighted: bool,
                  num_iters: int) -> KernelCall:
    """The call's ``KernelCall``, recorded in every open ``record_calls``
    scope."""
    k, m = x.shape
    call = _realized_call(plan, k, m, x.dtype, weighted, num_iters,
                          isinstance(x, RowTable))
    _record_call(call)
    return call


def _meta_out(x: Rows, plan: LaunchPlan) -> torch.Tensor:
    """The (N, M) estimate of a launch on the meta device (which passed
    the card's checks): its shape and dtype, computed by nothing."""
    return torch.empty((plan.n_out, x.shape[1]), dtype=x.dtype,
                       device=x.device)


def single_pass(x: Rows, a: torch.Tensor, plan: LaunchPlan, *,
                num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                weighted: bool = True) -> torch.Tensor:
    """Single-pass MM aggregation: (K, M) x (K, N) normalized -> (N, M).
    Launches the plan's variant of the CUDA kernel for a CUDA tensor or
    a ``RowTable``, runs the plain version for a CPU tensor."""
    k, m = x.shape
    call = _wrapper_call(x, plan, weighted, num_iters)
    if x.device.type == "cpu" and isinstance(x, torch.Tensor):
        xp, ap = _pad_inputs(x, a, plan=plan)
        return mm_single_pass_plain(xp, ap, k=k, num_iters=num_iters, c=c,
                                    weighted=weighted)[:, :m]
    _check_cuda_operands(x, a, plan, k)
    if x.device.type == "meta":
        return _meta_out(x, plan)
    out = torch.empty((plan.n_out, m), dtype=x.dtype, device=x.device)
    args, stream = _launch_args(x, a, out, plan)
    err = build.library("mm_single_pass").mm_single_pass_launch(
        *args, *call.args, num_iters, c, int(weighted), stream)
    if err:
        raise RuntimeError(f"mm_single_pass ({plan.variant}) launch failed: "
                           f"cudaError {err}")
    launches.note(call.key)
    return out


def two_pass(x: Rows, a: torch.Tensor, plan: LaunchPlan, *,
             num_iters: int = 10, c: float = mestimators.TUKEY_C95,
             weighted: bool = True) -> torch.Tensor:
    """Two-pass K-major MM aggregation, as ``single_pass``: one kernel
    launch per call, which sums the K block masses itself."""
    k, m = x.shape
    call = _wrapper_call(x, plan, weighted, num_iters)
    if x.device.type == "cpu" and isinstance(x, torch.Tensor):
        xp, ap = _pad_inputs(x, a, plan=plan)
        return mm_two_pass_plain(xp, ap, k=k, block_k=plan.block_k,
                                 num_iters=num_iters, c=c,
                                 weighted=weighted)[:, :m]
    _check_cuda_operands(x, a, plan, k)
    if x.device.type == "meta":
        return _meta_out(x, plan)
    out = torch.empty((plan.n_out, m), dtype=x.dtype, device=x.device)
    args, stream = _launch_args(x, a, out, plan)
    err = build.library("mm_two_pass").mm_two_pass_launch(
        *args, *call.args, num_iters, c, int(weighted), stream)
    if err:
        raise RuntimeError(f"mm_two_pass launch failed: cudaError {err}")
    launches.note(call.key)
    return out


def two_pass_blocks(plan: LaunchPlan, k: int, dtype=torch.float32,
                    weighted: bool = True) -> int:
    """Blocks the two-pass kernel launches for ``plan`` on the current
    card: min(column tiles, blocks the card holds at once), asked of the
    card and cached per device by the library.  Launches nothing."""
    blocks = ctypes.c_int64(0)
    err = build.library("mm_two_pass").mm_two_pass_blocks(
        _DTYPE_CODES[_as_dtype(dtype)], k, plan.m_total, plan.n_out,
        plan.block_k, plan.n_chunk, plan.block_m, int(weighted),
        ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"mm_two_pass_blocks failed: cudaError {err}")
    return blocks.value


def two_pass_exact_tiles() -> int:
    """Warp-tiles of the weighted group layout with 16 rows a lane (one K
    block of at most 128 rows) whose columns did not sort exactly on
    coarse keys and took the (key, row) sort, on the current card since
    the last call, which resets the count.  A launch of ``block_m``
    columns over M holds ceil(M / block_m) x max(1, block_m x lanes / 32)
    warp-tiles.  Waits for the launches before it."""
    tiles = ctypes.c_int64(0)
    err = build.library("mm_two_pass").mm_two_pass_exact_tiles(
        ctypes.byref(tiles))
    if err:
        raise RuntimeError(f"mm_two_pass_exact_tiles failed: cudaError {err}")
    return tiles.value


def _launch(x: Rows, a: torch.Tensor, *, weighted: bool,
            num_iters: int, c: float, block_m: Optional[int],
            block_k: Optional[int], path: Optional[str] = None,
            n_chunk: Optional[int] = None) -> torch.Tensor:
    """(K, M) values x (K, N) weights -> (N, M) through one kernel.

    Weight columns are normalized here (invalid columns become uniform):
    the kernels select the absolute cumulative-weight-1/2 crossing, so
    unnormalized weights would be wrong, not just scaled."""
    k, m = x.shape
    if isinstance(x, RowTable) and not weighted:
        # the kernels' unweighted columns are compiled without the table
        # path, which slowed their launches without a table
        raise ValueError("only a weighted launch reads a row table; pass "
                         "the rows of an unweighted one as a (K, M) tensor")
    if weighted:
        a = location.normalize_weights(a, dtype=torch.float32)
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    plan = launch_plan(k, m, a.shape[1], dtype=x.dtype, block_m=block_m,
                       block_k=block_k, path=path, n_chunk=n_chunk,
                       table=isinstance(x, RowTable))
    run = two_pass if plan.path == "two_pass" else single_pass
    return run(x, a, plan, num_iters=num_iters, c=c, weighted=weighted)


def mm_aggregate_2d(x: Rows, a: Optional[torch.Tensor] = None, *,
                    num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                    block_m: Optional[int] = None,
                    block_k: Optional[int] = None,
                    path: Optional[str] = None) -> torch.Tensor:
    """MM-aggregate a (K, M) tensor, or the K rows of a ``RowTable``,
    along axis 0 -> (M,).  ``a`` is an optional (K,) weight vector,
    normalized internally."""
    if isinstance(x, torch.Tensor) and x.dim() != 2:
        raise ValueError(f"mm_aggregate_2d wants (K, M), got {tuple(x.shape)}")
    k = x.shape[0]
    if a is None:
        aw = torch.full((k, 1), 1.0 / k, dtype=torch.float32, device=x.device)
        weighted = False
    else:
        if tuple(a.shape) != (k,):
            raise ValueError(f"weights must be ({k},), got {tuple(a.shape)}")
        aw, weighted = a.reshape(k, 1), True
    return _launch(x, aw, weighted=weighted, num_iters=num_iters, c=c,
                   block_m=block_m, block_k=block_k, path=path)[0]


def mm_aggregate_batched_2d(x: torch.Tensor, a: torch.Tensor, *,
                            num_iters: int = 10,
                            c: float = mestimators.TUKEY_C95,
                            block_m: Optional[int] = None,
                            block_k: Optional[int] = None,
                            path: Optional[str] = None) -> torch.Tensor:
    """(K, M) values x (K, N) weight columns -> (N, M), one launch; the
    x tile is read from HBM once whatever N is (the diffusion hot path)."""
    if x.dim() != 2 or a.dim() != 2 or a.shape[0] != x.shape[0]:
        raise ValueError(f"want x (K, M) and a (K, N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    return _launch(x, a, weighted=True, num_iters=num_iters, c=c,
                   block_m=block_m, block_k=block_k, path=path)
