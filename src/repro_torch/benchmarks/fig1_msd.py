"""Paper Fig. 1 reproduction (``benchmarks/fig1_msd.py``): MSD over
iterations for
(left) a single malicious agent across contamination strengths delta, and
(right) fixed delta=1000 across contamination rates.

Writes experiments/torch/fig1_left.csv / fig1_right.csv (one MSD column
per (aggregator, delta-or-rate)) plus a summary of steady-state MSDs,
and checks the paper's three claims in band form (``claims``).  Each run
draws from a ``torch.Generator`` seeded from its ``seed`` on ``device``
(the card unless the caller asks for the CPU).

One departure from the reference's claim logic: C3's clean-efficiency
clause (REF's clean steady MSD within 25% of the mean's) is taken on the
median ratio over ``C3_SEEDS``, as tests/test_paper_claims.py takes it,
not on the seed-0 ratio alone.  One run's ratio is noise-dominated (the
reference's test saw 0.98-1.50 across seeds): on an H100 seeds 0-3 gave
1.257, 1.003, 0.869 and 1.081, on the CPU 1.058, 0.945, 1.176 and
1.177.  The figure's curves and rows are seed 0's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.configs import paper_lsq
from repro_torch.core import attacks, diffusion, graph
from repro_torch.data import synthetic

AGGS = ("mean", "median", "mm_tukey")
# seeds of C3's clean-efficiency clause (tests/test_paper_claims.py's)
C3_SEEDS = (0, 1, 2, 3)
OUT_DIR = os.path.join("experiments", "torch")


def _run(agg: str, n_mal: int, delta: float, iters: int, seed: int = 0,
         device="cuda"):
    prob = synthetic.LinearModelProblem(dim=paper_lsq.DIM,
                                        noise_var=paper_lsq.NOISE_VAR)
    comb = graph.uniform_weights(graph.fully_connected(paper_lsq.NUM_AGENTS))
    byz = attacks.ByzantineConfig(
        num_malicious=n_mal, attack="additive",
        attack_kwargs=(("delta", delta),))
    cfg = diffusion.DiffusionConfig(step_size=paper_lsq.STEP_SIZE,
                                    aggregator=agg, byzantine=byz)
    _, hist = diffusion.run_diffusion(
        grad_fn=prob.grad_fn(device), combination=comb, config=cfg,
        w_star=prob.w_star(device), num_iters=iters,
        generator=torch.Generator(device=device).manual_seed(seed))
    return _numpy(hist)


def _numpy(h) -> np.ndarray:
    return h.cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h)


def steady(h: np.ndarray, frac: float = 0.2) -> float:
    return float(np.mean(h[-max(1, int(len(h) * frac)):]))


def claims(s: dict, clean_ratios=None) -> dict:
    """The paper's three claims in band form, from the steady MSD of each
    row name: {claim row name: bool}.  ``clean_ratios`` (REF's clean
    steady MSD over the mean's, one per seed of ``C3_SEEDS``) puts C3's
    efficiency clause on their median; without them it is the rows'."""
    c1 = s["fig1_left/mean/delta=1000"] > 1e3 * s["fig1_left/mean/delta=0"]
    c2 = (s["fig1_right/median/mal=1"] < 1e-2
          and s["fig1_left/median/delta=0"]
          > 1.2 * s["fig1_left/mean/delta=0"])
    efficient = (float(np.median(clean_ratios)) < 1.25 if clean_ratios
                 else s["fig1_left/mm_tukey/delta=0"]
                 < 1.25 * s["fig1_left/mean/delta=0"])
    c3 = (s["fig1_left/mm_tukey/delta=1000"] < 1e-2
          and efficient
          and s["fig1_right/mm_tukey/mal=11"] < 5e-2)
    return {"fig1/claim_C1_mean_breakdown": bool(c1),
            "fig1/claim_C2_median_robust_inefficient": bool(c2),
            "fig1/claim_C3_ref_robust_and_efficient": bool(c3)}


def clean_ratios(iters: int, s: dict, device="cuda") -> list:
    """REF's clean steady MSD over the mean's for each seed of
    ``C3_SEEDS``: seed 0's from the figure's rows ``s``, the others run."""
    out = [s["fig1_left/mm_tukey/delta=0"] / s["fig1_left/mean/delta=0"]]
    for seed in C3_SEEDS[1:]:
        ref = steady(_run("mm_tukey", 0, 0.0, iters, seed, device))
        out.append(ref / steady(_run("mean", 0, 0.0, iters, seed, device)))
    return out


def main(iters: int = None, out_dir: str = OUT_DIR, device="cuda",
         detail=None) -> list[tuple]:
    """The figure's rows; ``detail``, a dict, also receives C3's clean
    ratios (``c3_clean_ratios``)."""
    iters = iters or paper_lsq.NUM_ITERS
    os.makedirs(out_dir, exist_ok=True)
    rows = []

    # ---- left panel: single attacker, delta sweep -----------------------
    left_cols, left_names = [], []
    for agg in AGGS:
        for delta in paper_lsq.DELTA_GRID:
            t0 = time.perf_counter()
            h = _run(agg, 1 if delta > 0 else 0, delta, iters, device=device)
            dt = (time.perf_counter() - t0) * 1e6 / iters
            left_cols.append(h)
            left_names.append(f"{agg}_d{delta:g}")
            rows.append((f"fig1_left/{agg}/delta={delta:g}", dt, steady(h)))
    np.savetxt(os.path.join(out_dir, "fig1_left.csv"),
               np.stack(left_cols, 1), delimiter=",",
               header=",".join(left_names), comments="")

    # ---- right panel: fixed delta=1000, rate sweep -----------------------
    right_cols, right_names = [], []
    for agg in AGGS:
        for n_mal in paper_lsq.RATE_GRID:
            t0 = time.perf_counter()
            h = _run(agg, n_mal, 1000.0, iters, device=device)
            dt = (time.perf_counter() - t0) * 1e6 / iters
            right_cols.append(h)
            right_names.append(f"{agg}_m{n_mal}")
            rows.append((f"fig1_right/{agg}/mal={n_mal}", dt, steady(h)))
    np.savetxt(os.path.join(out_dir, "fig1_right.csv"),
               np.stack(right_cols, 1), delimiter=",",
               header=",".join(right_names), comments="")

    # ---- beyond-paper ablation: raised Tukey c for small-K efficiency ----
    # The median/MAD init supplies the breakdown point, so the refinement
    # loss can be widened (c=8 ~ 99% asymptotic efficiency) without losing
    # robustness at K=32.
    for n_mal, delta in ((0, 0.0), (1, 1000.0), (11, 1000.0)):
        prob = synthetic.LinearModelProblem(dim=paper_lsq.DIM,
                                            noise_var=paper_lsq.NOISE_VAR)
        comb = graph.uniform_weights(
            graph.fully_connected(paper_lsq.NUM_AGENTS))
        byz = attacks.ByzantineConfig(
            num_malicious=n_mal, attack="additive",
            attack_kwargs=(("delta", delta),))
        cfg = diffusion.DiffusionConfig(
            step_size=paper_lsq.STEP_SIZE, aggregator="mm_tukey",
            agg_kwargs=(("c", 8.0),), byzantine=byz)
        _, h = diffusion.run_diffusion(
            grad_fn=prob.grad_fn(device), combination=comb, config=cfg,
            w_star=prob.w_star(device), num_iters=iters,
            generator=torch.Generator(device=device).manual_seed(0))
        rows.append((f"fig1_beyond/mm_tukey_c8/mal={n_mal}_d{delta:g}",
                     0.0, steady(_numpy(h))))

    # ---- claim checks ----------------------------------------------------
    s = {r[0]: r[2] for r in rows}
    ratios = clean_ratios(iters, s, device)
    if detail is not None:
        detail["c3_clean_ratios"] = ratios
    for name, ok in claims(s, ratios).items():
        rows.append((name, 0.0, float(ok)))
    return rows


if __name__ == "__main__":
    for name, us, derived in main():
        print(f"{name},{us:.2f},{derived:.6g}")
