"""Two-pass K-major kernel with several K blocks: the plain PyTorch
version against the JAX two-pass kernel in interpret mode.  The init and
scale are then the reference's median-of-medians approximation, so the
port is held to the JAX *kernel*, not the oracle (ROADMAP queue 3).
"""

import pytest

from test_torch_two_pass import RTOL, both, make

import numpy as np


@pytest.mark.parametrize("k,m,n,block_k,weighted", [
    (96, 257, 2, 32, True), (1024, 64, 1, 512, False),
    (1024, 64, 1, 512, True)])
def test_two_pass_several_blocks_matches_the_jax_kernel(k, m, n, block_k,
                                                        weighted):
    x, a = make(k, m, n, seed=k * 3 + n)
    got, want = both(x, a, block_k=block_k)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)


def test_two_pass_partial_last_block_and_massless_block():
    """K = 70 at block_k = 32: the last block holds 6 valid rows; the
    middle block carries no weight, so it leaves the combine."""
    x, a = make(70, 96, 1, seed=5)
    a[32:64] = 0.0
    got, want = both(x, a, block_k=32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)
