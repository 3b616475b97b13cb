"""The MM kernels reading their rows through a device table of row
addresses (``mm_aggregate.RowTable``), as the service's launch program
reads its cohort.

On the CPU: what a ``RowTable`` stands for, the wrappers' refusal of
one that is not on a card or not a (K,) int64 table (the plain versions
read tensors), and the launch plan's shared memory of a table launch:
the group layout's copy of the table counted, every K block still
fitting, and no tile changed by it.

Marked ``cuda`` (they skip without a card; run them on one with
``pytest -m cuda tests/test_torch_row_table.py``): each layout the
service can reach -- ``regs``, ``warp`` and ``smem`` of the single pass,
the two-pass kernel's group layout (one K block) and its warp layout
(several) -- launched over a table of rows that lie apart, at addresses
not aligned to 16 bytes, gives the launch over the (K, M) tensor of the
same values bit for bit, repeated addresses included, and so do the
warp layout's launches at K 4096 and 8192, where a copy of the table in
shared memory would not fit beside the widest tile; the launch program
reads its rows where they lie (a row changed after staging changes the
next replay) and holds them only from a stage to its release; a
service commit on the card is the eager launch over the stacked cohort,
bit for bit; and the weighted group layout of 16 rows a lane, which
sorts on coarse keys that carry the row, gives the plain version's
estimate through a table and through (x, ld) alike, with the share of
warp-tiles its exact-tile count reads that the numpy model of its
check predicts (a few percent on the serve cohort's mix, none on narrow
data, all on clustered columns)."""

import pytest
import torch

from repro_torch.core import location
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.kernels import ops


def test_a_row_table_stands_for_its_rows():
    table = torch.zeros(5, dtype=torch.int64)
    rows = mk.RowTable(table, 7, torch.bfloat16)
    assert rows.shape == (5, 7) and rows.device == table.device
    assert rows.dtype == torch.bfloat16


@pytest.mark.parametrize("table,match", [
    (torch.zeros(4, dtype=torch.int64), "CUDA tensors"),
    (torch.zeros(8, dtype=torch.int64, device="meta")[::2], "row table"),
    (torch.zeros(4, dtype=torch.int32, device="meta"), "row table")])
def test_the_wrappers_refuse_a_table_they_cannot_launch(table, match):
    """A table on the CPU has no plain version to run, and one that is
    not a (K,) int64 tensor is refused before any launch."""
    rows = mk.RowTable(table, 10, torch.float32)
    with pytest.raises(ValueError, match=match):
        mk.mm_aggregate_2d(rows, torch.ones(4))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("k", [8, 48, 128, 300, 600])
def test_only_a_weighted_launch_reads_a_row_table(k, weighted):
    """Every kernel layout (regs at 8 rows, smem at 48, the two-pass group
    layout at 128 and 300, its warp layout at 600) takes a row table in a
    weighted launch; an unweighted launch refuses one before it
    launches."""
    rows = mk.RowTable(torch.zeros(k, dtype=torch.int64, device="meta"),
                       20_000, torch.float32)
    if weighted:
        assert mk.mm_aggregate_2d(rows, torch.ones(k)).shape == (20_000,)
    else:
        with pytest.raises(ValueError, match="only a weighted launch"):
            mk.mm_aggregate_2d(rows)


@pytest.mark.parametrize("n", [1, 32, 256])
def test_a_table_plan_counts_the_table_and_keeps_its_tile(n):
    """A table launch's plan counts the group layout's copy of the k row
    addresses (8 k bytes past the layout's own, on a 16-byte boundary),
    fits the block at every K of one K block, and keeps the tile of the
    launch over a (K, M) tensor; with several K blocks the table is read
    where it lies and the plan is the tensor launch's."""
    for k in (*range(65, 513, 7), 512, 600, 1024, 4096, 8192):
        plain = mk.launch_plan(k, 1 << 20, n, path="two_pass")
        plan = mk.launch_plan(k, 1 << 20, n, path="two_pass", table=True)
        assert plan._replace(smem_bytes=plain.smem_bytes) == plain, k
        if plan.num_k_blocks == 1:
            assert plan.smem_bytes == \
                -(-plain.smem_bytes // 16) * 16 + 8 * k, k
            assert plan.smem_bytes <= mk.SMEM_BUDGET_BYTES, (k, n)
        else:
            assert plan.smem_bytes == plain.smem_bytes, k
        call = mk.kernel_call(plan, k=k, m=1 << 20, table=True)
        assert call.smem == plan.smem_bytes


# ===========================================================================
# on a card
# ===========================================================================

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a row table is read by the kernels, "
                    "which have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _scattered(k, m, dtype, device, seed, shift=1000.0):
    """k rows of m values in one buffer at a stride of a multiple of four
    elements, row i at an offset of i % 4 more, so rows lie apart and
    three in four addresses are not 16-byte aligned; the last k // 8 rows
    shifted by ``shift``."""
    g = torch.Generator(device=device).manual_seed(seed)
    stride = (m + 7) // 4 * 4
    base = torch.randn(k * stride, generator=g, device=device).to(dtype)
    rows = [base[i * stride + i % 4:][:m] for i in range(k)]
    for r in rows[k - k // 8:]:
        r += shift
    return rows


def _table(rows):
    return mk.RowTable(torch.tensor([r.data_ptr() for r in rows],
                                    dtype=torch.int64,
                                    device=rows[0].device),
                       rows[0].numel(), rows[0].dtype)


# (k, m, dtype, the plan it takes): the layouts the service can reach
LAYOUTS = [
    (8, (1 << 20) + 3, torch.float32, "regs"),
    (8, (1 << 20) + 3, torch.bfloat16, "regs"),
    (8, 1000, torch.float32, "warp"),
    (48, 9001, torch.float32, "smem"),
    (128, (1 << 20) + 3, torch.float32, "group"),
    (300, 70_001, torch.float32, "group"),
    (600, 4099, torch.float32, "two-pass warp"),
]


def _layout(plan):
    if plan.path == "single":
        return plan.variant
    return "group" if plan.num_k_blocks == 1 else "two-pass warp"


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("k,m,dtype,layout", LAYOUTS,
                         ids=[f"{lay}-{k}x{m}-{str(d)[6:]}"
                              for k, m, d, lay in LAYOUTS])
def test_a_table_launch_is_the_tensor_launch_bit_for_bit(card, k, m, dtype,
                                                         layout, weighted):
    rows = _scattered(k, m, dtype, card, seed=k + m)
    assert len({r.data_ptr() % 16 for r in rows}) > 1
    assert _layout(mk.launch_plan(k, m, 1, dtype=dtype)) == layout
    g = torch.Generator(device=card).manual_seed(7)
    a = torch.rand(k, generator=g, device=card) + 0.5 if weighted else None
    if not weighted:
        with pytest.raises(ValueError, match="only a weighted launch"):
            mk.mm_aggregate_2d(_table(rows), a)
        return
    want = mk.mm_aggregate_2d(torch.stack(rows), a)
    got = mk.mm_aggregate_2d(_table(rows), a)
    assert got.dtype == dtype and got.shape == (m,)
    assert torch.equal(got, want), layout


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4096, 8192])
def test_a_wide_cohort_table_launch_fits_and_is_the_tensor_launch(card, k):
    """The warp layout at K 4096 (the widest tile, 8 columns) and 8192 (4
    columns), where the plan leaves less than 8 k bytes of the block's
    shared memory free: a weighted table launch runs and gives the
    tensor launch's bits."""
    m = 2051
    rows = _scattered(k, m, torch.float32, card, seed=k)
    plan = mk.launch_plan(k, m, 1, table=True)
    assert plan.num_k_blocks > 1
    assert plan.smem_bytes + 8 * k > mk.SMEM_BUDGET_BYTES
    a = torch.rand(k, device=card) + 0.5
    assert torch.equal(mk.mm_aggregate_2d(_table(rows), a),
                       mk.mm_aggregate_2d(torch.stack(rows), a))


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(8, 70_001), (128, 70_001)])
def test_repeated_addresses_on_the_card(card, k, m):
    """Anchor rows (one tensor in several slots) and a Byzantine row sent
    twice read as the stacked cohort does."""
    rows = _scattered(k, m, torch.float32, card, seed=k)
    rows[k - 3:] = [rows[0]] * 3
    rows[1] = rows[2]
    a = torch.rand(k, device=card) + 0.5
    assert torch.equal(mk.mm_aggregate_2d(_table(rows), a),
                       mk.mm_aggregate_2d(torch.stack(rows), a))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 128])
def test_the_launch_program_reads_its_rows_where_they_lie(card, k):
    """The captured program's replay is the eager launch over the stacked
    rows; a row changed in place after staging changes the next replay
    the same way, so nothing of a row was copied at the stage; a row on
    another device is refused.  The compile lends the program its zero
    rows for the warm-up and the capture alone, and after a release the
    program holds no rows and refuses a replay."""
    m = 50_003
    rows = _scattered(k, m, torch.float32, card, seed=3 * k)
    a = torch.rand(k, device=card) + 0.5
    engine = ops.AggregationEngine()
    program = engine.lower_launch(k, m, device=card).compile()
    assert program.graph is not None and program.rows == ()
    program.stage(rows, a)
    assert program.table.tolist() == [r.data_ptr() for r in rows]
    assert torch.equal(program.replay(),
                       engine.aggregate(torch.stack(rows), a))
    rows[0].mul_(-3.0)
    assert torch.equal(program.replay(),
                       engine.aggregate(torch.stack(rows), a))
    with pytest.raises(ValueError, match="is on cpu"):
        program.stage([rows[0].cpu(), *rows[1:]], a)
    program.release()
    with pytest.raises(RuntimeError, match="holds no rows"):
        program.replay()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 128])
def test_a_service_commit_is_the_stacked_launch(card, k):
    """A commit of a service on the card (its program reading the
    payloads through the table; one Byzantine payload sent by two
    members) gives the model the eager launch over the stacked cohort
    gives, bit for bit."""
    from repro_torch.serve import AgentUpdate, AggregationService, \
        ServeConfig, SimClock
    m = 65_537
    rows = _scattered(k, m, torch.float32, card, seed=11 * k)
    rows[k - 2] = rows[k - 1]
    svc = AggregationService(torch.zeros(m, device=card),
                             config=ServeConfig(k_min=k, deadline_s=1.0),
                             clock=SimClock(), device=card)
    for agent, row in enumerate(rows):
        svc.submit(AgentUpdate(agent_id=agent, round=0, payload=row, seq=1))
    assert svc.round == 1
    eager = ops.get_engine(num_iters=svc.config.num_iters).aggregate(
        torch.stack(rows), torch.ones(k, device=card))
    assert torch.equal(svc.model, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cohort", "narrow", "clustered"])
def test_coarse_keys_give_the_plain_estimate_through_a_table_and_x(card,
                                                                   kind):
    """The weighted (128, 2^20, 1) launch (one 128-row K block, the group
    layout of 16 rows a lane) on the serve cohort's mix (112 N(0, 1) rows
    and 16 copies of row 0 + 1000), on narrow data (1000 + N(0, 1e-3))
    and on clustered columns (rows at -1000 and 1000, the rest 1 + j ulp,
    j < 100): through a row table and through a strided (x, ld) view the
    same bits and the same exact-tile count, within the card's parity
    tolerance of the plain version; the count a few percent of the
    warp-tiles on the mix, none on narrow data (the relative scale), and
    every one on the clustered columns."""
    k, m = 128, 1 << 20
    g = torch.Generator(device=card).manual_seed(32)
    buf = torch.randn((k, m + 5), generator=g, device=card)
    x = buf[:, :m]
    if kind == "cohort":
        x[k - k // 8:] = x[0] + 1000.0
    elif kind == "narrow":
        x.mul_(1e-3).add_(1000.0)
    else:
        x.copy_(1.0 + torch.randint(0, 100, (k, m), generator=g,
                                    device=card).float() * 2.0 ** -23)
        x[0], x[1] = -1000.0, 1000.0
    a = torch.rand(k, generator=g, device=card) + 0.5
    plan = mk.launch_plan(k, m, 1, table=True)
    assert plan.path == "two_pass" and plan.num_k_blocks == 1
    assert mk.two_pass_rows(plan.block_k) == 16
    mk.two_pass_exact_tiles()                     # reset the count
    got = mk.mm_aggregate_2d(x, a)
    tiles = mk.two_pass_exact_tiles()
    assert torch.equal(mk.mm_aggregate_2d(_table(list(x)), a), got)
    assert mk.two_pass_exact_tiles() == tiles
    lanes = mk.two_pass_lanes(plan.block_k)
    warp_tiles = -(-m // plan.block_m) * max(1, plan.block_m * lanes // 32)
    share = tiles / warp_tiles
    want_share = {"cohort": (0.005, 0.06), "narrow": (0.0, 0.0),
                  "clustered": (1.0, 1.0)}[kind]
    assert want_share[0] <= share <= want_share[1], share
    aw = location.normalize_weights(a.reshape(k, 1), dtype=torch.float32)
    xp, ap = mk._pad_inputs(x.contiguous(), aw, plan=plan)
    want = mk.mm_two_pass_plain(xp, ap, k=k, block_k=plan.block_k)[0, :m]
    tol = 1e-5 * max(1.0, float(x.abs().max()))
    assert float((got - want).abs().max()) <= tol
