"""The reference's MM estimate against a brute-force one written out
per column in float64, at tiny K and M."""

import numpy as np
import pytest
import torch

from reference import mm


def _brute(x: np.ndarray, a=None, iters=10, c=4.685) -> np.ndarray:
    k, m = x.shape
    out = np.empty(m)
    w = np.full(k, 1.0 / k) if a is None else a / a.sum()
    for j in range(m):
        col = x[:, j]
        order = sorted(range(k), key=lambda i: (col[i], i))
        if a is None:
            s = [col[i] for i in order]
            med = 0.5 * (s[(k - 1) // 2] + s[k // 2])
        else:
            cum = 0.0
            for i in order:
                cum += w[i]
                if cum >= 0.5:
                    med = col[i]
                    break
        dev = sorted(abs(v - med) for v in col)
        scale = max(1.4826022185056018 * 0.5 * (dev[(k - 1) // 2]
                                                + dev[k // 2]), 1e-12)
        mu = med
        for _ in range(iters):
            num = den = 0.0
            for i in range(k):
                u = min(max(1.0 - ((col[i] - mu) / scale) ** 2 / c ** 2,
                            0.0), 1.0)
                num += w[i] * u * u * col[i]
                den += w[i] * u * u
            if den > 1e-12:
                mu = num / den
        out[j] = mu
    return out


@pytest.mark.parametrize("k", [3, 4, 8, 9])
@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_matches_brute_force(k, weighted):
    rng = np.random.default_rng(k + 10 * weighted)
    x = rng.standard_normal((k, 37))
    x[-1] += 1000.0                       # one attacker, as in the cells
    x[:, 5] = 0.25                        # a column of ties
    a = rng.uniform(0.2, 1.5, k) if weighted else None
    got = mm.estimate(torch.from_numpy(x).float(),
                      None if a is None else torch.from_numpy(a).float())
    want = _brute(x.astype(np.float32).astype(np.float64), a)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_blocks_equal_whole():
    x = torch.randn(8, 1000)
    a = torch.rand(8) + 0.5
    whole = mm.estimate(x, a)
    blocks = mm.estimate_blocks(lambda lo, hi: x[:, lo:hi], 1000, a, block=97)
    torch.testing.assert_close(whole, blocks, rtol=0, atol=1e-6)


def test_bfloat16_control_departs():
    x = torch.randn(8, 4096)
    x[7] += 1000.0
    f32 = mm.estimate(x)
    bf16 = mm.estimate(x, dtype=torch.bfloat16).float()
    assert float((f32 - bf16).abs().max()) > 1e-3
