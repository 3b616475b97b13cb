"""Single-pass kernel, batched over N weight columns: the plain PyTorch
version against the JAX Pallas kernel in interpret mode (one launch for
all N neighbourhoods, as diffusion makes it).  f32 atol 1e-5, rtol 1e-6."""

import numpy as np
import pytest

from test_torch_kernels import M, RTOL, make, run_both


@pytest.mark.parametrize("k", [3, 5, 16, 32, 33, 64])
@pytest.mark.parametrize("n", [5, 32])
def test_single_pass_plain_matches_pallas_batched(k, n):
    x, a = make(k, n, seed=k * 31 + n)
    got, want = run_both(x, a, batched=True)
    assert got.shape == (n, M)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=RTOL)


def test_invalid_weight_column_falls_back_to_uniform():
    x, a = make(8, 3, seed=4)
    a[:, 1] = 0.0
    a[2, 2] = -1.0
    got, want = run_both(x, a, batched=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=RTOL)
