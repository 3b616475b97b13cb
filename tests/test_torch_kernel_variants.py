"""The single-pass kernel's three variants (regs, warp, smem): the launch
plan's choice among them, and the rounding argument for their IRLS in
reciprocal form, on the CPU.

The CUDA variants themselves run only on the card, where ``chip_smoke.py``
holds each against ``mm_single_pass_plain``.  Here a torch transcription
of the reciprocal IRLS (inv = 1 / (c scale) once, then y = (x - mu) inv,
u = max(1 - y^2, 0), summed in sorted order as ``regs`` sums) is held to
the plain version within the tolerance the card's parity uses,
1e-5 x max(1, |x|_inf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mm_aggregate as JK
from repro_torch.core import mestimators
from repro_torch.kernels import launches
from repro_torch.kernels import mm_aggregate as TK

PAPER, FEDERATED = (32, 10, 32), (16, 10, 1)
TREE, BATCH, COHORT = (8, 751_894_528, 1), (32, 2 ** 20, 32), (512, 256, 1)


@pytest.mark.parametrize("shape,path,variant", [
    (PAPER, "single", "warp"), (FEDERATED, "single", "warp"),
    (TREE, "single", "regs"), (BATCH, "single", "regs"),
    (COHORT, "two_pass", None)])
def test_main_path_shapes_get_their_variant(shape, path, variant):
    plan = TK.launch_plan(*shape)
    assert (plan.path, plan.variant) == (path, variant)
    assert plan.smem_bytes <= TK.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("variant,k", [("regs", 33), ("regs", 64),
                                       ("regs", 300), ("warp", 65)])
def test_a_variant_named_past_its_rows_raises(variant, k):
    with pytest.raises(ValueError, match="holds at most"):
        TK.launch_plan(k, 100_000, 1, variant=variant)


def test_an_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown single-pass variant"):
        TK.launch_plan(8, 100, 1, variant="tensor_cores")


@pytest.mark.parametrize("k,m,n,want", [
    (32, TK.REGS_MIN_COLUMNS, 4, "regs"), (32, TK.REGS_MIN_COLUMNS - 1, 4,
                                          "regs"),
    (32, TK.WARP_MAX_PAIRS, 1, "warp"), (32, TK.WARP_MAX_PAIRS + 1, 1, "regs"),
    (33, TK.REGS_MIN_COLUMNS, 1, "smem"), (8, 100, 32, "warp"),
    (64, TK.WARP_MAX_PAIRS, 1, "warp"), (64, TK.WARP_MAX_PAIRS + 1, 1,
                                         "smem"),
    (32, 5000, 1, "regs"), (33, 10 ** 6, 1, "smem"), (64, 8192, 1, "smem"),
    (1, 7, 1, "warp"), (300, 10 ** 6, 1, "smem")])
def test_variant_crossovers(k, m, n, want):
    assert TK.single_pass_variant(k, m, n) == want
    assert TK.launch_plan(k, m, n, path="single").variant == want


@pytest.mark.parametrize("n,last_single", [(1, 68), (3, 72), (32, 112)])
def test_auto_path_is_unchanged_by_the_variants(n, last_single):
    """No variant's choice enters the single/two-pass crossover: K <= 64
    takes a single-pass variant (smem over wide M x N from K = 33), and
    from 65 agents the two-pass kernel, but for the few agents over 64
    where the smem variant stayed faster at this N on the card."""
    for k in range(2, 2049):
        want = "single" if k <= last_single else "two_pass"
        assert TK.auto_path(k, n) == want, (k, n)
        plan = TK.launch_plan(k, 4096, n)
        assert plan.path == want
        assert (plan.variant is None) == (want == "two_pass")
        if 64 < k <= last_single:
            assert plan.variant == "smem"
    assert TK.launch_plan(64, TK.WARP_MAX_PAIRS + 1, n).variant == "smem"


def test_variant_shared_memory_models():
    for k, n, bm in ((5, 1, 256), (32, 32, 128), (64, 1, 256)):
        assert TK.variant_smem_bytes("smem", k, n, bm) == \
            TK.single_pass_smem_bytes(k, n, bm)
        assert TK.variant_smem_bytes("regs", k, n, bm) == 4 * k * (n | 1)
        assert TK.variant_smem_bytes("warp", k, n, bm) == 0


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 50)).astype(np.float32))
    a = torch.full((8, 1), 1 / 8)
    before = launches.COUNTS.copy()
    assert TK.MM_KERNELS == (*TK.SINGLE_PASS_VARIANTS, "two_pass")
    want = TK.single_pass(x, a, TK.launch_plan(8, 50, 1), weighted=False)
    for variant in TK.SINGLE_PASS_VARIANTS:
        plan = TK.launch_plan(8, 50, 1, variant=variant)
        got = TK.single_pass(x, a, plan, weighted=False)
        assert torch.equal(got, want)
    assert launches.COUNTS == before


# ---------------------------------------------------------------------------
# the rounding argument
# ---------------------------------------------------------------------------

def make(k, m, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2.0) / 2.0 + 0.0
    else:
        x[-max(1, k // 5):] += 1000.0                 # delta = 1000
    if kind == "mad_floor":
        x[:, ::3] = 3.0
    a = rng.uniform(0.1, 1.0, size=(k, 2)).astype(np.float32)
    if kind == "ties":
        a[:] = 1.0                                    # crossings on 1/2
    return x, a / a.sum(0)


def reciprocal_estimate(x, a, *, weighted, num_iters=10,
                        c=mestimators.TUKEY_C95):
    """The CUDA variants' arithmetic in torch: the plain version's sort,
    crossing and MAD, then IRLS with one reciprocal per (column, n) and
    sums in sorted order."""
    k = x.shape[0]
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    aws = TK._gather_rows(a, order)                         # (K, N, M)
    if weighted:
        med = TK._crossing(xs[:, None, :], aws, 0.5)
    else:
        med = TK._rank_median(xs, k)[None]
    ds = torch.sort(torch.abs(xs[:, None, :] - med[None]), dim=0).values
    scale = torch.clamp(TK._MAD_CONSISTENCY * TK._rank_median(ds, k),
                        min=TK._SCALE_FLOOR)
    inv = 1.0 / (torch.tensor(c, dtype=torch.float32) * scale)
    mu = med.expand_as(scale).clone()
    for _ in range(num_iters):
        num = torch.zeros_like(mu)
        den = torch.zeros_like(mu)
        for j in range(k):
            y = (xs[j] - mu) * inv
            u = torch.clamp(1.0 - y * y, min=0.0)
            w = aws[j] * (u * u)
            num = num + w * xs[j]
            den = den + w
        safe = den > TK._SCALE_FLOOR
        mu = torch.where(safe, num / torch.where(safe, den,
                                                 torch.ones_like(den)), mu)
    return mu


@pytest.mark.parametrize("kind", ["contaminated", "ties", "mad_floor"])
@pytest.mark.parametrize("k", [3, 8, 32])
def test_reciprocal_irls_stays_within_parity_of_the_plain_version(k, kind):
    x, a = make(k, 257, kind, seed=10 * k + len(kind))
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    tol = 1e-5 * max(1.0, float(np.abs(x).max()))
    for weighted, aw in ((True, ta), (False, torch.full((k, 1), 1.0 / k))):
        got = reciprocal_estimate(tx, aw, weighted=weighted)
        want = TK.mm_single_pass_plain(tx, aw, k=k, weighted=weighted)
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= tol, (weighted, kind)


@pytest.mark.parametrize("kind", ["ties", "mad_floor"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_version_matches_pallas_on_ties_and_the_mad_floor(kind,
                                                                weighted):
    """The edge columns chip_smoke.py holds every variant to: the plain
    version agrees with the JAX kernel there too."""
    k = 16
    x, a = make(k, 130, kind, seed=7)
    ja = jnp.asarray(a[:, 0]) if weighted else None
    ta = torch.from_numpy(a[:, 0].copy()) if weighted else None
    want = np.asarray(JK.mm_aggregate_2d(jnp.asarray(x), ja, interpret=True))
    got = TK.mm_aggregate_2d(torch.from_numpy(x), ta)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
