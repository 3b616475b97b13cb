"""Claim C3 of the paper (tests/test_paper_claims.py) through
``repro_torch.scenarios.run`` on the CPU, same specs and bands: REF is
robust for every delta and, in the clean case, its steady MSD is within
25% of the mean's (median ratio over four seeds)."""

import numpy as np

from test_torch_paper_claims import msd_curve, steady


def test_c3_ref_robust_and_efficient():
    for d in (1.0, 100.0, 1000.0):
        assert steady(msd_curve("mm_tukey", 1, d)) < 1e-2, d
    ratios = []
    for seed in range(4):
        ref_clean = steady(msd_curve("mm_tukey", 0, 0.0, iters=800, seed=seed))
        mean_clean = steady(msd_curve("mean", 0, 0.0, iters=800, seed=seed))
        ratios.append(ref_clean / mean_clean)
    assert float(np.median(ratios)) < 1.25, ratios
