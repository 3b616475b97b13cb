"""Single-pass kernel: its plain PyTorch version against the JAX Pallas
kernel in interpret mode (the way tests/test_kernels.py runs it).

The port's wrapper runs the plain version for CPU tensors, so
``repro_torch.kernels.mm_aggregate.mm_aggregate_2d`` /
``mm_aggregate_batched_2d`` on CPU exercise exactly the arithmetic the
CUDA kernel is held to on the card (``chip_smoke.py``).  Inputs come from
numpy with a seed, 20% of the rows contaminated by delta = 1000, and M
not a multiple of any tile.  f32: atol 1e-5 plus rtol 1e-6 (sum order
differs, and an estimate on a contaminated row is ~1000); bf16:
within one bf16 ulp of the JAX output.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import mm_aggregate as JK
from repro_torch.kernels import mm_aggregate as TK

M = 300
# sums run in another order: where the weighted median lands on a
# contaminated row the estimate is ~1000, whose f32 ulp is 6e-5
RTOL = 1e-6


def make(k, n, seed, weighted=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, M)).astype(np.float32)
    x[-max(1, k // 5):] += 1000.0
    a = rng.uniform(0.1, 1.0, size=(k, n)).astype(np.float32) \
        if weighted else None
    return x, a


def run_both(x, a, *, batched):
    if batched:
        want = JK.mm_aggregate_batched_2d(jnp.asarray(x), jnp.asarray(a),
                                          interpret=True)
        got = TK.mm_aggregate_batched_2d(torch.from_numpy(np.asarray(x)),
                                         torch.from_numpy(a))
    else:
        ja = None if a is None else jnp.asarray(a[:, 0])
        ta = None if a is None else torch.from_numpy(a[:, 0])
        want = JK.mm_aggregate_2d(jnp.asarray(x), ja, interpret=True)
        got = TK.mm_aggregate_2d(torch.from_numpy(np.asarray(x)), ta)
    return got, np.asarray(want)


@pytest.mark.parametrize("k", [3, 5, 16, 32, 33, 64])
@pytest.mark.parametrize("weighted", [False, True])
def test_single_pass_plain_matches_pallas_n1(k, weighted):
    x, a = make(k, 1, seed=k, weighted=weighted)
    got, want = run_both(x, a, batched=False)
    assert got.shape == (M,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("k", [3, 16, 33])
def test_single_pass_bf16_within_one_ulp(k):
    x, a = make(k, 1, seed=100 + k)
    xb = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(JK.mm_aggregate_2d(jnp.asarray(xb), jnp.asarray(a[:, 0]),
                                         interpret=True), np.float32)
    tx = torch.from_numpy(xb.view(np.int16).copy()).view(torch.bfloat16)
    got = TK.mm_aggregate_2d(tx, torch.from_numpy(a[:, 0]))
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_weighted_path_takes_the_lower_middle_at_even_k():
    """Uniform weights through the weighted path cross 1/2 exactly at row
    K/2 - 1 (the lower middle); only a=None takes the rank midpoint."""
    x = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    a = np.ones((4, 1), np.float32)
    got_w = TK.mm_aggregate_2d(torch.from_numpy(x), torch.from_numpy(a[:, 0]),
                               num_iters=0)
    got_u = TK.mm_aggregate_2d(torch.from_numpy(x), num_iters=0)
    assert float(got_w[0]) == 2.0 and float(got_u[0]) == 2.5
    assert float(JK.mm_aggregate_2d(jnp.asarray(x), jnp.asarray(a[:, 0]),
                                    num_iters=0, interpret=True)[0]) == 2.0


def test_ragged_m_pads_with_zero_columns_not_inf():
    x, _ = make(6, 1, seed=9, weighted=False)
    plan = TK.launch_plan(6, 7, 1, block_m=32)
    xp, ap = TK._pad_inputs(torch.from_numpy(x[:, :7]),
                            torch.full((6, 1), 1 / 6), plan=plan)
    assert xp.shape == (6, 32) and bool((xp[:, 7:] == 0).all())
    out = TK.mm_single_pass_plain(xp, ap, k=6, weighted=False)
    assert bool(torch.isfinite(out).all())
