"""Two-pass shapes the first Hopper kernel could not launch: the plain
PyTorch version against the JAX two-pass kernel in interpret mode, on
the same numpy inputs.

The JAX kernel walks N in ``n_chunk`` chunks and takes any number of K
blocks; the port's kernel stages ``n_chunk`` weight columns at a time
and combines any number of K blocks, and its plan must fit those shapes
in a Hopper block's 232,448 B of shared memory.  With several K blocks
the estimate is the reference's median-of-medians approximation, so the
port is held to the JAX *kernel*, not the oracle (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mestimators
from repro.kernels import mm_aggregate as JK
from repro_torch.kernels import mm_aggregate as TK

from test_torch_two_pass import RTOL, make

BUDGET = 232_448


def both(x, a, *, weighted=True, block_k=None, n_chunk=None):
    """(port, JAX kernel) on the same inputs, both forced to two-pass."""
    if a is None:
        a = np.full((x.shape[0], 1), 1.0 / x.shape[0], np.float32)
        weighted = False
    kw = dict(weighted=weighted, num_iters=10, c=mestimators.TUKEY_C95,
              block_m=None, block_k=block_k, path="two_pass", n_chunk=n_chunk)
    want = JK._launch(jnp.asarray(x), jnp.asarray(a), interpret=True, **kw)
    got = TK._launch(torch.from_numpy(x), torch.from_numpy(a), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n_chunk", [4, 7, None])
def test_n_past_the_chunk_matches_the_jax_kernel(n_chunk):
    """K = 96, N = 40: the JAX kernel walks N in chunks of n_chunk; the
    port's plan stages that many weight columns at a time."""
    x, a = make(96, 33, 40, seed=40)
    plan = TK.launch_plan(96, 33, 40, path="two_pass", n_chunk=n_chunk)
    if n_chunk is not None:
        assert plan.n_chunk == n_chunk < 40
    got, want = both(x, a, n_chunk=n_chunk)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("weighted", [True, False])
def test_eighteen_k_blocks_match_the_jax_kernel(weighted):
    """K = 1100 at block_k 64: 18 K blocks, the last of 12 rows."""
    x, a = make(1100, 20, 1, seed=18, weighted=weighted)
    plan = TK.launch_plan(1100, 20, 1, path="two_pass", block_k=64)
    assert plan.num_k_blocks == 18 and plan.smem_bytes <= BUDGET
    got, want = both(x, a, block_k=64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("blocks", [(1,), (0, 5), (7, 8, 9)])
def test_massless_k_blocks_leave_the_combine(blocks):
    """K = 1100 at block_k 64 with the weights of some K blocks 0: those
    blocks carry no mass into the combine."""
    x, a = make(1100, 20, 2, seed=sum(blocks))
    for b in blocks:
        a[b * 64:(b + 1) * 64] = 0.0
    got, want = both(x, a, block_k=64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("k,n", [(200, 200), (256, 256), (4096, 8),
                                 (512, 512), (8192, 1)])
def test_shapes_the_first_kernel_could_not_fit_now_fit(k, n):
    """Every (K, N) here overflowed the first kernel's block; the new
    plan fits 232,448 B at any M, with one tile the full K."""
    assert TK.auto_path(k, n) == "two_pass"
    for m in (1031, 4099, 15_730_944):
        plan = TK.launch_plan(k, m, n)
        assert plan.path == "two_pass" and plan.smem_bytes <= BUDGET
        assert plan.block_m in TK.TWO_PASS_BLOCK_MS
        assert plan.k_pad == plan.num_k_blocks * plan.block_k >= k
        assert 1 <= plan.n_chunk <= n
        assert plan.input_bytes == k * m * 4      # x read once


def test_shared_memory_model_counts_every_buffer():
    """The model (and the C function it mirrors) at one K block, several,
    and past 32 K blocks, where each warp sorts its combine in a strip."""
    assert TK.two_pass_smem_bytes(512, 1, 512, 8) == \
        4 * (512 * 8 + 512 + 2 * 8 + 1)
    assert TK.two_pass_smem_bytes(8192, 1, 512, 4) == \
        4 * (8192 * 4 + 8192 + 2 * 16 * 4 + 16) + 2 * 8192 * 4
    assert TK.two_pass_smem_bytes(2048, 3, 32, 8) == \
        8 * 8 * 64 + 4 * (2048 * 8 + 3 * 2048 + 2 * 64 * 8 + 64 * 3) \
        + 2 * 2048 * 8


def test_n_chunk_caps_the_weight_slice():
    plan = TK.launch_plan(256, 2 ** 16, 256)
    assert plan.n_chunk == 64 and 4 * 64 * 256 <= 64 * 1024
    assert TK.launch_plan(512, 1024, 8).n_chunk == 8
    assert TK.launch_plan(512, 1024, 300, n_chunk=1000).n_chunk == 300
