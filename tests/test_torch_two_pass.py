"""Two-pass K-major kernel: its plain PyTorch version against the JAX
two-pass kernel in interpret mode.

With one K block (KB = 1: K in {65, 128, 300}) the two-pass estimate is
exact, so it must also match the oracle at 1e-5.  With several blocks
(K = 96 at block_k = 32, KB = 3; K = 1024 at block_k = 512, KB = 2) the
init and scale are the reference's median-of-medians approximation, and
the port is held to the JAX *kernel*, not the oracle (ROADMAP queue 3:
the JAX kernel itself is up to 0.05-0.09 off the oracle there).  M stays
<= 1024: interpret mode is slow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mm_aggregate as JK
from repro.kernels import ref as jref
from repro_torch.kernels import mm_aggregate as TK

RTOL = 1e-6   # as in test_torch_kernels: ~1000-valued estimates


def make(k, m, n, seed, weighted=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, m)).astype(np.float32)
    x[-(k // 5):] += 1000.0
    a = rng.uniform(0.1, 1.0, size=(k, n)).astype(np.float32) \
        if weighted else None
    return x, a


def both(x, a, block_k=None):
    if a is None:
        want = JK.mm_aggregate_2d(jnp.asarray(x), interpret=True,
                                  path="two_pass", block_k=block_k)[None]
        got = TK.mm_aggregate_2d(torch.from_numpy(x), path="two_pass",
                                 block_k=block_k)[None]
    else:
        want = JK.mm_aggregate_batched_2d(jnp.asarray(x), jnp.asarray(a),
                                          interpret=True, path="two_pass",
                                          block_k=block_k)
        got = TK.mm_aggregate_batched_2d(torch.from_numpy(x),
                                         torch.from_numpy(a),
                                         path="two_pass", block_k=block_k)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k,m,n,weighted", [
    (65, 130, 1, True), (128, 257, 2, True), (300, 64, 3, True),
    (128, 200, 1, False)])
def test_two_pass_single_block_matches_kernel_and_oracle(k, m, n, weighted):
    x, a = make(k, m, n, seed=k + n)
    got, want = both(x, a)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)
    if a is None:
        oracle = np.asarray(jref.mm_aggregate_ref(jnp.asarray(x)))[None]
    else:
        oracle = np.asarray(jref.mm_aggregate_batched_ref(jnp.asarray(x),
                                                          jnp.asarray(a)))
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=RTOL)


def test_two_pass_plain_reads_only_valid_rows():
    """+inf sentinel rows and zero M columns never reach the estimate."""
    x, a = make(65, 37, 1, seed=8)
    plan = TK.launch_plan(65, 37, 1, block_m=8, path="two_pass")
    xp, ap = TK._pad_inputs(torch.from_numpy(x), torch.from_numpy(a),
                            plan=plan)
    assert xp.shape == (128, 40) and bool(torch.isinf(xp[65:, :37]).all())
    assert bool((xp[:, 37:] == 0).all())
    out = TK.mm_two_pass_plain(xp, TK.location.normalize_weights(ap),
                               k=65, block_k=plan.block_k)
    assert bool(torch.isfinite(out).all())
