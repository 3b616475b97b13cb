"""The paper's Sec. 4 claims (tests/test_paper_claims.py) rerun through
``repro_torch.scenarios.run`` on the CPU, with the same specs, iteration
counts and bands; only the random streams differ (torch.Generator).

  C1  mean aggregation breaks down as delta grows (single attacker);
  C2  elementwise median is robust but less statistically efficient;
  C3  REF (MM/Tukey) is robust across delta and contamination rate, and
      matches mean-based MSD in the clean case (tests/test_torch_paper_c3.py);
  Theorem 1: iterates approach the benign optimum within O(mu).
"""

from repro_torch import scenarios
from repro_torch.configs import paper_lsq

steady = scenarios.steady   # trailing-20% steady-state level


def msd_curve(agg, n_mal, delta, iters=500, seed=0):
    sp = scenarios.ScenarioSpec(
        paradigm="diffusion", num_agents=paper_lsq.NUM_AGENTS,
        dim=paper_lsq.DIM, noise_var=paper_lsq.NOISE_VAR,
        topology="fully_connected", aggregator=agg,
        attack="additive", num_malicious=n_mal,
        attack_kwargs=(("delta", delta),),
        step_size=paper_lsq.STEP_SIZE, num_steps=iters,
        seed=seed, data_seed=0)
    return scenarios.run(sp, device="cpu").history["msd"]


def test_c1_mean_breaks_down_with_delta():
    msds = [steady(msd_curve("mean", 1, d)) for d in (0.0, 10.0, 1000.0)]
    assert msds[1] > 10 * msds[0]
    assert msds[2] > 1e3 * msds[0]


def test_c2_median_robust_but_inefficient():
    med_attacked = steady(msd_curve("median", 1, 1000.0))
    assert med_attacked < 1e-2
    med_clean = steady(msd_curve("median", 0, 0.0, iters=800))
    mean_clean = steady(msd_curve("mean", 0, 0.0, iters=800))
    assert med_clean > 1.3 * mean_clean


def test_c3_ref_robust_across_contamination_rate():
    for n_mal in (3, 7, 11):
        m = steady(msd_curve("mm_tukey", n_mal, 1000.0))
        assert m < 5e-2, (n_mal, m)


def test_limiting_point_is_benign_optimum():
    h = msd_curve("mm_tukey", 7, 1000.0, iters=800)
    assert steady(h) < 10 * paper_lsq.STEP_SIZE
    tail = h[-160:]
    assert tail.std() < 5 * tail.mean()
