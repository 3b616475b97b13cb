"""Kernel-contract checker (``repro.analysis.contracts``).

Verifies ``mm_aggregate.launch_plan`` against the launch the wrappers
really make (``mm_aggregate.kernel_call``: the ``KernelCall`` whose
arguments ``single_pass``/``two_pass`` hand to the C entry points), for
both kernels and every single-pass variant, without launching anything.
On a card it also asks the C entry points what they would launch
(``mm_aggregate.launch_query``, through the same dispatch as a launch)
and holds the Python call to that answer.

  grid-mismatch   the units the call's blocks walk are the plan's
                  ``grid[0]``; on the card the C query names the same
                  instantiation and launches the same blocks, threads and
                  shared memory.  Everything below keys off the walk, so
                  a mismatch stops the audit.
  one-residency   the walk (block b takes units b, b + stride, ...)
                  visits each unit exactly once; the launch's tile loads
                  are the plan's modeled ``input_block_fetches``; each x
                  element is loaded once; a load brings the plan's
                  (block_k, block_m) tile (a column's whole K_pad rows
                  stay on chip: the smem model holds them); the plan's
                  input bytes are the x operand's.
  n-independence  re-planning at 4N + 1 (the same tile, path and
                  variant) leaves the input traffic and the walk
                  unchanged: the N axis must not enter the launch.
  hbm-stats       the launch has exactly three operands (x, a, the
                  estimate) and one HBM output, the (N, M) estimate: the
                  two-pass block stats live in shared memory only (the
                  plan's ``stats_bytes`` is part of its ``smem_bytes``).
  smem-model      the call's shared memory is the plan's ``smem_bytes``
                  and the model of its kernel at the plan's geometry; on
                  the card also the C ``mm_*_smem_bytes`` and the query's.
  smem-budget     the plan fits ``SMEM_BUDGET_BYTES`` (227 KB a block),
                  unless the overflow is unavoidable (below).
  occupancy       (card only) at least one block of the launch is
                  resident on an SM.
  path-crossover  with no tuning winner and nothing pinned, the plan's
                  path is ``auto_path(k, n)``.

``check_workloads`` audits ``DEFAULT_WORKLOADS``: the reference's matrix
and the full-width shapes the port launches; the mutation tests feed
broken calls through ``audit_call`` to prove each rule has teeth.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import mm_aggregate as mk

# (k, m, n, dtype, path): the reference's seven (both paths, weighted
# batching, bf16 streams, the auto-resolved path of a large-K mesh), then
# the full widths the port launches: Qwen3-0.6B's tree, one decoder
# layer under a 128- and a 512-client cohort, the 256-agent and the
# 32-agent diffusion batches
DEFAULT_WORKLOADS: Tuple[tuple, ...] = (
    (8, 1000, 1, "float32", None),
    (16, 512, 16, "float32", "single"),
    (16, 300, 4, "bfloat16", None),
    (33, 700, 5, "float32", None),
    (128, 512, 4, "float32", "two_pass"),
    (1024, 2048, 1, "float32", None),
    (1024, 600, 8, "bfloat16", "two_pass"),
    (8, 751_894_528, 1, "float32", None),
    (128, 15_730_944, 1, "float32", None),
    (512, 15_730_944, 1, "float32", None),
    (256, 65_536, 256, "float32", None),
    (32, 1_048_576, 32, "float32", None),
)


def _where(plan: mk.LaunchPlan) -> str:
    tag = plan.variant or plan.path
    return (f"K{plan.k_pad}xM{plan.m_total}xN{plan.n_out}"
            f"/{tag}/bm{plan.block_m}_bk{plan.block_k}")


def walk_visits(units: int, blocks: int, stride: int) -> Tuple[int, int]:
    """(fewest, most) visits of any of ``units`` units when block b of
    ``blocks`` takes units b, b + stride, b + 2 stride, ...; worked out
    arithmetically (a full-width walk has millions of units)."""
    if units < 1 or blocks < 1 or stride < 1:
        return 0, 0
    if stride >= blocks:
        # one block a residue class at most: a unit whose residue has no
        # block (r >= blocks) is never visited
        return (0 if stride > blocks and units > blocks else 1), 1
    # unit u is visited by the blocks u mod stride, + stride, ... up to
    # min(u, blocks - 1); the last `stride` units reach the most of them
    most = max((min(u, blocks - 1) - u % stride) // stride + 1
               for u in range(max(0, units - stride), units))
    return 1, most


def audit_call(plan: mk.LaunchPlan, call: mk.KernelCall, *,
               query: Optional[dict] = None) -> List[Finding]:
    """Audit one launch against its plan (and, given the C entry point's
    ``launch_query``, against what the card would launch)."""
    out: List[Finding] = []
    where = _where(plan)

    def finding(rule: str, detail: str, ident: str = "") -> None:
        out.append(Finding(rule=rule, path="kernel", where=where,
                           detail=detail, ident=ident))

    # --- the walk must be the plan's, and on the card the C launch's ---
    if call.units != plan.grid[0]:
        finding("grid-mismatch",
                f"the launch walks {call.units} units; the plan's grid "
                f"has {plan.grid[0]}")
        return out
    if query is not None:
        held = query["per_sm"] * query["sms"]
        want = {"instantiation": call.instantiation,
                "blocks": call.blocks(held), "threads": call.threads,
                "smem": call.smem}
        got = {key: query[key] for key in want}
        if got != want:
            finding("grid-mismatch",
                    f"the C entry point launches {got}; the Python call "
                    f"says {want}", ident="query")
            return out

    # --- one-residency: each unit once, each x element loaded once ---
    blocks = call.blocks(query["per_sm"] * query["sms"]
                         if query is not None else None)
    stride = call.stride or blocks
    fewest, most = walk_visits(call.units, blocks, stride)
    if most > 1:
        finding("one-residency",
                f"the walk of {blocks} blocks at stride {stride} "
                f"visits a unit {most} times: some tile is streamed from "
                "HBM more than once per launch", ident="refetch")
    if fewest < 1:
        finding("one-residency",
                f"the walk of {blocks} blocks at stride {stride} "
                f"leaves units of the {call.units} unvisited",
                ident="coverage")
    if call.loads != plan.input_block_fetches:
        finding("one-residency",
                f"the launch makes {call.loads} tile loads; the plan "
                f"models {plan.input_block_fetches} fetches")
    k, m = call.k, call.m
    loaded = call.loads * call.tile[0] * call.tile[1]
    if loaded > plan.k_pad * plan.m_total:
        finding("one-residency",
                f"{call.loads} loads of a {call.tile} tile bring "
                f"{loaded / (k * m):.3g} x the ({k}, {m}) operand on "
                "chip: x elements are loaded more than once",
                ident="reload")
    if tuple(call.tile) != (plan.block_k, plan.block_m):
        finding("one-residency",
                f"a load brings a {tuple(call.tile)} tile; the plan's "
                f"is ({plan.block_k}, {plan.block_m})",
                ident="block-shape")
    itemsize = torch.empty((), dtype=mk._as_dtype(
        call.operands[0].dtype)).element_size()
    if plan.input_bytes != k * m * itemsize:
        finding("one-residency",
                f"the plan models {plan.input_bytes} input bytes; the "
                f"({k}, {m}) operand holds {k * m * itemsize}",
                ident="bytes")

    # --- N-independence: input traffic must not scale with N ---
    alt_n = plan.n_out * 4 + 1
    alt = mk.launch_plan(k, m, alt_n, dtype=call.operands[0].dtype,
                         block_m=plan.block_m, block_k=plan.block_k,
                         path=plan.path, variant=plan.variant)
    alt_call = mk.kernel_call(alt, k=k, m=m, dtype=call.operands[0].dtype,
                              weighted=call.weighted)
    if (alt.input_bytes, alt.input_block_fetches, alt_call.units,
            alt_call.loads) != (plan.input_bytes, plan.input_block_fetches,
                                call.units, call.loads):
        finding("n-independence",
                f"input traffic changes with N: N={plan.n_out} walks "
                f"{call.units} units with {call.loads} loads, N={alt_n} "
                f"walks {alt_call.units} with {alt_call.loads} -- the N "
                "axis entered the launch")

    # --- HBM surface: three operands, one output, never the stats ---
    if len(call.operands) != 3:
        finding("hbm-stats",
                f"the launch has {len(call.operands)} operands; it takes "
                "x, a and the estimate only", ident="operands")
    if len(call.outputs) != 1:
        finding("hbm-stats",
                f"the launch writes {len(call.outputs)} HBM outputs; the "
                "only HBM write is the (N, M) estimate -- per-K-block "
                "stats must stay in shared memory")
    stats_shape = (plan.num_k_blocks, plan.n_out, plan.block_m)
    for o in call.outputs:
        if tuple(o.shape) == stats_shape and plan.path == "two_pass":
            finding("hbm-stats",
                    f"a {stats_shape} per-K-block stat buffer is an HBM "
                    "output; stats must live only in shared memory",
                    ident="stats-output")
        elif tuple(o.shape) != (plan.n_out, m) \
                or o.dtype != call.operands[0].dtype:
            finding("hbm-stats",
                    f"unexpected HBM output {tuple(o.shape)} {o.dtype}; "
                    f"the estimate is ({plan.n_out}, {m}) "
                    f"{call.operands[0].dtype}", ident="extra-output")
    if plan.path == "two_pass" and not 0 < plan.stats_bytes <= \
            plan.smem_bytes:
        finding("hbm-stats",
                f"the two-pass block stats ({plan.stats_bytes} B) are not "
                f"within the block's shared memory ({plan.smem_bytes} B)",
                ident="stats-smem")

    # --- shared memory: the call's is the plan's and the model's ---
    if plan.path == "two_pass":
        model = mk.two_pass_smem_bytes(k, plan.n_chunk, plan.block_k,
                                       plan.block_m)
    else:
        model = mk.variant_smem_bytes(plan.variant, k, plan.n_out,
                                      plan.block_m)
    if call.smem != plan.smem_bytes:
        finding("smem-model",
                f"the launch carves {call.smem} B of shared memory a "
                f"block; the plan models {plan.smem_bytes}")
    if plan.smem_bytes != model:
        finding("smem-model",
                f"plan.smem_bytes {plan.smem_bytes} != the "
                f"{plan.variant or plan.path} model {model} at the plan's "
                "geometry", ident="plan-model")
    if query is not None and not (query["smem"] == query["smem_model"]
                                  == call.smem):
        finding("smem-model",
                f"the C entry point carves {query['smem']} B and models "
                f"{query['smem_model']}; the Python call {call.smem}",
                ident="c-model")
    if plan.smem_bytes > mk.SMEM_BUDGET_BYTES:
        # the one sanctioned overflow: a mesh below the two-pass
        # crossover whose variant overflows even at the narrowest tile
        # (the launch then refuses it); anything else means a narrower
        # tile or the two-pass path would have fit
        narrow = mk.variant_smem_bytes(plan.variant or "smem", k,
                                       plan.n_out, mk._MIN_BLOCK_M)
        forced_small_mesh = (plan.path == "single"
                             and plan.k_pad < mk._TWO_PASS_MIN_K
                             and narrow > mk.SMEM_BUDGET_BYTES)
        if not forced_small_mesh:
            finding("smem-budget",
                    f"the plan carves {plan.smem_bytes} B a block, over "
                    f"SMEM_BUDGET_BYTES ({mk.SMEM_BUDGET_BYTES}), and the "
                    "geometry was avoidable: a narrower tile or the "
                    "two-pass path fits")

    # --- occupancy: a block of this launch must fit an SM ---
    if query is not None and query["per_sm"] < 1:
        finding("occupancy",
                f"{call.instantiation} at {call.threads} threads and "
                f"{call.smem} B: no block is resident on an SM")
    return out


def check_workload(k: int, m: int, n: int, dtype="float32",
                   path: Optional[str] = None, *,
                   block_m: Optional[int] = None,
                   block_k: Optional[int] = None,
                   variant: Optional[str] = None,
                   weighted: bool = True,
                   on_card: bool = False) -> List[Finding]:
    """Plan + realize one workload and audit the pair (``on_card``: with
    the C entry point's query on the current card)."""
    dt = mk._as_dtype(dtype)
    plan = mk.launch_plan(k, m, n, dtype=dt, block_m=block_m,
                          block_k=block_k, path=path, variant=variant)
    call = mk.kernel_call(plan, k=k, m=m, dtype=dt, weighted=weighted)
    query = mk.launch_query(call) if on_card else None
    findings = audit_call(plan, call, query=query)
    # auto-resolution: with nothing pinned and no tuning winner naming a
    # path, the plan's path is the crossover's
    if path is None and block_m is None and block_k is None \
            and variant is None:
        from repro_torch.kernels import tuning
        if tuning.get_choice(k, m, n=n, dtype=dt).path is None:
            want = mk.auto_path(k, n)
            if plan.path != want:
                findings.append(Finding(
                    rule="path-crossover", path="kernel",
                    where=_where(plan),
                    detail=f"auto-resolved path {plan.path!r} disagrees "
                           f"with the crossover {want!r} "
                           "(and no tuning winner pins it)"))
    return findings


def check_workloads(workloads: Iterable[tuple] = DEFAULT_WORKLOADS, *,
                    on_card: Optional[bool] = None) -> List[Finding]:
    """The contracts pass: audit every workload in the matrix (with the
    C queries on a card; ``on_card`` None: where one is present)."""
    card = torch.cuda.is_available() if on_card is None else on_card
    out: List[Finding] = []
    for wl in workloads:
        out.extend(check_workload(*wl, on_card=card))
    return out


def describe(k: int, m: int, n: int, dtype="float32",
             path: Optional[str] = None, *, variant: Optional[str] = None,
             weighted: bool = True, on_card: bool = False) -> dict:
    """The Python ``KernelCall`` of a workload beside the C query (on the
    card): what ``chip_smoke.py`` prints for each shape it checks."""
    dt = mk._as_dtype(dtype)
    plan = mk.launch_plan(k, m, n, dtype=dt, path=path, variant=variant)
    call = mk.kernel_call(plan, k=k, m=m, dtype=dt, weighted=weighted)
    row = {"workload": [k, m, n, mk.dtype_name(dt)],
           "python": {"instantiation": call.instantiation,
                      "units": call.units, "grid_stride": call.grid_stride,
                      "threads": call.threads, "smem": call.smem}}
    if on_card:
        q = mk.launch_query(call)
        row["python"]["blocks"] = call.blocks(q["per_sm"] * q["sms"])
        row["c"] = q
        row["equal"] = all(row["python"][key] == q[key] for key in
                           ("instantiation", "blocks", "threads", "smem"))
    return row

